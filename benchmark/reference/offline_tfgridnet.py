"""Plain PyTorch reference of the offline TF-GridNet trunk and of the
LookOnceToHear enrollment network (`EmbedTFGridNet`, configs/embed.json),
written from the published description (espnet2's `TFGridNet` and
`GridNetBlock` as the reference repository's
src/models/tfgridnet_orig/tfgridnet.py uses them) and independent of the
program: it imports neither the port nor the JAX package.

  x / std(x) over (mics, samples), unbiased -> centered STFT (reflect
  pad n_fft/2, periodic Hann window, one-sided) -> [real; imag] of every
  mic -> Conv2d(2M, C, 3x3, pad 1) + GroupNorm(1, C) -> N GridNet blocks:
    intra: LayerNorm over C -> the (k, 1) unfold over frequency, stride
      1 -> BiLSTM -> ConvTranspose1d(2H, C, k) -> + the block's input;
    inter: the same over time;
    attention: a 1x1 conv + PReLU + LayerNorm over (channels, F) a head
      for Q, K (E' = ceil(512 / F) channels) and V (C / heads), full
      softmax attention over time scaled by 1 / sqrt(E' F), the heads
      concatenated, 1x1 conv + PReLU + LayerNorm over (C, F) -> + z;
  -> [B, T, C F] (C-major) -> Linear(C F, 256) + LayerNorm -> mean over
  time: the d-vector.

Sizes configs/embed.json leaves out are the published constructor's:
C = 64 channels, H = 64 hidden units, 4 heads, approx_qk_dim 512,
k = 4, eps 1e-5. Float32; `mode` "tf32" turns TF32 on for every product
(the control), "f32" off.

Departures from the published description, none of which changes the
function it computes:
* the STFT is a product with the windowed real DFT's cos and -sin
  columns, not an FFT, so that a flop counter sees it;
* the LSTM is an explicit loop over time, both directions in one
  batched product a step (the backward one over the time-reversed
  input);
* the weights are drawn from the seed (`param_table`) under the names
  of the port's state dict, so that both sides load one dictionary.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

from benchmark.reference import precision

# the published constructor's sizes (EmbedTFGridNet, espnet2 GridNetBlock)
CHANNELS, HIDDEN, HEADS, QK_DIM, KERNEL, EPS = 64, 64, 4, 512, 4, 1e-5


def dims(mp: dict) -> dict:
    """The network's sizes from a configuration's `model_params`."""
    f = mp["n_fft"] // 2 + 1
    return dict(nfft=mp["n_fft"], hop=mp["stride"], F=f, M=mp["num_ch"],
                B=mp["num_blocks"], E=mp["embed_dim"], C=CHANNELS, H=HIDDEN,
                nh=HEADS, k=KERNEL, e=math.ceil(QK_DIM / f),
                vd=CHANNELS // HEADS)


def frames(mp: dict, samples: int) -> int:
    """Frames of the centered STFT of `samples` samples."""
    return samples // mp["stride"] + 1


def trunk_table(d: dict, prefix: str) -> list:
    """(name, shape, offset, scale) of every weight of the trunk: a
    weight is drawn as offset + scale * U(-1, 1). Products and their
    biases take 1 / sqrt(fan in), norm gains 1 +- 0.1, shifts +- 0.1,
    PReLU slopes 0.25 +- 0.05."""
    c, h, f, k, nh = d["C"], d["H"], d["F"], d["k"], d["nh"]
    rows = []

    def dense(name, shape, fan_in):
        s = 1.0 / math.sqrt(fan_in)
        rows.extend([(f"{name}.weight", shape, 0.0, s),
                     (f"{name}.bias", (shape[1] if len(shape) == 3
                                       else shape[0],), 0.0, s)])

    def norm(name, shape, names=("gamma", "beta")):
        rows.extend([(f"{name}.{names[0]}", shape, 1.0, 0.1),
                     (f"{name}.{names[1]}", shape, 0.0, 0.1)])

    def lstm(name):
        s = 1.0 / math.sqrt(h)
        for sfx in ("_l0", "_l0_reverse"):
            rows.extend([(f"{name}.w_ih{sfx}", (4 * h, c * k), 0.0, s),
                         (f"{name}.w_hh{sfx}", (4 * h, h), 0.0, s),
                         (f"{name}.b_ih{sfx}", (4 * h,), 0.0, s),
                         (f"{name}.b_hh{sfx}", (4 * h,), 0.0, s)])

    def head(name, n_out):
        dense(name, (n_out, c), c)
        rows.append((f"{name}.act.weight", (1,), 0.25, 0.05))
        norm(f"{name}.norm", (1, n_out, 1, f))

    dense(f"{prefix}.conv", (c, 2 * d["M"], 3, 3), 2 * d["M"] * 9)
    norm(f"{prefix}.conv_norm", (1, c, 1, 1), ("weight", "bias"))
    for i in range(d["B"]):
        p = f"{prefix}.blocks.{i}"
        for stage in ("intra", "inter"):
            norm(f"{p}.{stage}_norm", (1, c, 1, 1))
            lstm(f"{p}.{stage}_rnn")
            # ConvTranspose1d's weight [in, out, k]; an output sums in x k
            dense(f"{p}.{stage}_linear", (2 * h, c, k), 2 * h * k)
        for name, n_out in (("attn_q", d["e"]), ("attn_k", d["e"]),
                            ("attn_v", d["vd"])):
            for j in range(nh):
                head(f"{p}.{name}.{j}", n_out)
        head(f"{p}.attn_concat_proj", c)
    return rows


def param_table(mp: dict) -> list:
    """Every weight of `EmbedNet` (the port's state-dict names)."""
    d = dims(mp)
    s = 1.0 / math.sqrt(d["C"] * d["F"])
    return trunk_table(d, "net.trunk") + [
        ("net.embed_proj_dense.weight", (d["E"], d["C"] * d["F"]), 0.0, s),
        ("net.embed_proj_dense.bias", (d["E"],), 0.0, s),
        ("net.embed_proj_norm.weight", (d["E"],), 1.0, 0.1),
        ("net.embed_proj_norm.bias", (d["E"],), 0.0, 0.1)]


# -- the network --------------------------------------------------------

def normalize(x, dims_, gamma, beta):
    """(x - mean) / sqrt(biased var + eps) over `dims_`, then gamma, beta."""
    var, mu = torch.var_mean(x, dim=dims_, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + EPS) * gamma + beta


def stft(x, nfft: int, hop: int):
    """Centered one-sided STFT of x [B, M, N] with a periodic Hann
    window: (real, imag), each [B, M, T, F]."""
    pad = nfft // 2
    fr = nnf.pad(x, (pad, pad), mode="reflect").unfold(-1, nfft, hop)
    n = torch.arange(nfft, dtype=torch.float64)
    window = 0.5 - 0.5 * torch.cos(2 * math.pi * n / nfft)
    ang = 2 * math.pi * n[:, None] * torch.arange(nfft // 2 + 1) / nfft
    cos = (window[:, None] * torch.cos(ang)).float().to(x.device)
    sin = (-window[:, None] * torch.sin(ang)).float().to(x.device)
    return fr @ cos, fr @ sin


def bilstm(x, p, name):
    """x [N, L, I] -> [N, L, 2H]: a step loop over both directions at
    once, the backward one over the time-reversed input."""
    sfx = ("_l0", "_l0_reverse")
    w_ih = torch.stack([p[f"{name}.w_ih{s}"] for s in sfx])    # [2, 4H, I]
    w_hh = torch.stack([p[f"{name}.w_hh{s}"].T for s in sfx])  # [2, H, 4H]
    bias = torch.stack([p[f"{name}.b_ih{s}"] + p[f"{name}.b_hh{s}"]
                        for s in sfx])
    xp = torch.stack([x, x.flip(1)]) @ w_ih.transpose(1, 2)[:, None] \
        + bias[:, None, None]                                  # [2, N, L, 4H]
    h = c = x.new_zeros((2, x.shape[0], w_hh.shape[1]))
    ys = []
    for step in range(x.shape[1]):
        g = xp[:, :, step] + torch.bmm(h, w_hh)
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    y = torch.stack(ys, dim=2)                                 # [2, N, L, H]
    return torch.cat([y[0], y[1].flip(1)], dim=-1)


def unfold_lstm(x, p, name, k: int):
    """espnet's unfold -> BiLSTM -> ConvTranspose1d over the last axis
    of x [N, C, L] -> [N, C, L]."""
    y = nnf.unfold(x[..., None], (k, 1)).transpose(1, 2)   # [N, L-k+1, Ck]
    y = bilstm(y, p, f"{name}_rnn")
    return nnf.conv_transpose1d(y.transpose(1, 2), p[f"{name}_linear.weight"],
                                p[f"{name}_linear.bias"])


def head(x, p, name):
    """1x1 conv + PReLU + LayerNorm over (channels, F): [B, C, T, F] ->
    [B, C', T, F]."""
    y = torch.einsum("bctf,oc->botf", x, p[f"{name}.weight"]) \
        + p[f"{name}.bias"][None, :, None, None]
    y = torch.where(y >= 0, y, p[f"{name}.act.weight"] * y)
    return normalize(y, (1, 3), p[f"{name}.norm.gamma"],
                     p[f"{name}.norm.beta"])


def block(x, p, name, d):
    """One offline GridNet block on [B, C, T, F]."""
    b, c, t, f = x.shape
    y = normalize(x, (1,), p[f"{name}.intra_norm.gamma"],
                  p[f"{name}.intra_norm.beta"])
    y = unfold_lstm(y.transpose(1, 2).reshape(b * t, c, f), p,
                    f"{name}.intra", d["k"])                   # [BT, C, F]
    y = y.reshape(b, t, c, f).transpose(1, 2) + x
    z = normalize(y, (1,), p[f"{name}.inter_norm.gamma"],
                  p[f"{name}.inter_norm.beta"])
    z = unfold_lstm(z.permute(0, 3, 1, 2).reshape(b * f, c, t), p,
                    f"{name}.inter", d["k"])                   # [BF, C, T]
    z = z.reshape(b, f, c, t).permute(0, 2, 3, 1) + y
    # espnet stacks the heads batch-wise, head-major
    nh, vd = d["nh"], d["vd"]
    q, k_, v = (torch.cat([head(z, p, f"{name}.{proj}.{j}")
                           for j in range(nh)]) for proj in
                ("attn_q", "attn_k", "attn_v"))             # [nh B, ., T, F]
    q = q.transpose(1, 2).flatten(2)                        # [nh B, T, E'F]
    k_ = k_.transpose(1, 2).flatten(2)
    v = v.transpose(1, 2)                                   # [nh B, T, vd, F]
    a = torch.softmax(q @ k_.transpose(1, 2) / math.sqrt(q.shape[-1]), dim=2)
    v = (a @ v.flatten(2)).reshape(v.shape).transpose(1, 2)  # [nh B, vd, T, F]
    out = v.reshape(nh, b, vd, t, f).transpose(0, 1).reshape(b, nh * vd, t, f)
    return head(out, p, f"{name}.attn_concat_proj") + z


def trunk(x, p, d, prefix: str):
    """x [B, M, N] std-normalized -> features [B, C, T, F]."""
    real, imag = stft(x, d["nfft"], d["hop"])
    h = nnf.conv2d(torch.cat([real, imag], dim=1), p[f"{prefix}.conv.weight"],
                   p[f"{prefix}.conv.bias"], padding=1)
    h = normalize(h, (1, 2, 3), p[f"{prefix}.conv_norm.weight"],
                  p[f"{prefix}.conv_norm.bias"])
    for i in range(d["B"]):
        h = block(h, p, f"{prefix}.blocks.{i}", d)
    return h


def forward(mp: dict, params: dict, x, mode: str = "f32"):
    """The d-vectors [B, E] of x [B, M, N] float32 ({name: float32
    tensor} weights on x's device), with no gradient, every product in
    `mode`'s precision."""
    d = dims(mp)
    with torch.no_grad(), precision(mode):
        x = x / torch.std(x, dim=(1, 2), keepdim=True)
        h = trunk(x, params, d, "net.trunk")
        b, c, t, f = h.shape
        h = h.transpose(1, 2).reshape(b, t, c * f)
        e = h @ params["net.embed_proj_dense.weight"].T \
            + params["net.embed_proj_dense.bias"]
        e = normalize(e, (-1,), params["net.embed_proj_norm.weight"],
                      params["net.embed_proj_norm.bias"])
        return e.mean(dim=1)
