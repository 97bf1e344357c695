"""Plain PyTorch reference of the streaming TF-GridNet separator (the
LookOnceToHear `Net`), written from the architecture and independent of
the program: it imports neither the port nor the JAX package.

It runs over a block of T frames from a carried state, so that a long
stream is computed block by block in bounded memory and one block of
a whole utterance is the training forward:

  filterbank STFT of each frame -> causal 3x3 conv over 2 carried
  frames -> the d-vector's projection multiplied in before block 1 ->
  GridNet blocks (LayerNorm, intra-frequency BiLSTM, LayerNorm,
  inter-time LSTM from the carried (h, c), and with attention heads
  causal attention over the w-1 previous frames and the current one)
  -> causal 3x3 deconv over 2 carried frames -> filterbank synthesis,
  overlap-added to the previous frame's synthesis (carried).

Every product is a plain matmul, einsum, conv2d or `torch.nn.LSTM`
(an explicit loop over time with `loop_lstm`, so that
`torch.utils.flop_counter` sees all of the model's products).
Attention before the stream start sees zero keys and values (score 0),
the semantics of a zero-initialised K/V ring.
With `kv_int8` the w-1 previous frames' keys and values are read back
through symmetric int8 per (row, frame, head) with scale amax / 127,
the current frame at full precision: the int8 serving ring's
semantics.

`mode` sets the precision of every product: "f32" (the caller turns
TF32 off), "tf32" (the caller turns it on) and "fp8" (both operands of
every product rounded through float8 e4m3 with a per-tensor scale).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as nnf

from benchmark.reference import precision

# frames of the serving reference per block (bounds its memory)
REF_FRAMES = 512
# queries per einsum of the banded attention: bounds the gathered
# window [rows, TQ, w-1, F*dim]
ATTN_QUERIES = 128


def dims(mp: dict) -> dict:
    """The model's sizes from a configuration's `model_params`."""
    hop = mp["stft_chunk_size"]
    nfft = hop + mp["stft_pad_size"]
    f = nfft // 2 + 1
    nh = mp["L"] if mp["use_attn"] else 0
    c = mp["D"]
    return dict(hop=hop, nfft=nfft, F=f, C=c, H=mp["H"], B=mp["B"],
                M=mp["num_ch"], S=mp.get("num_src", 2), E=mp["embed_dim"],
                nh=nh, e=int(math.ceil(512 / f)) if nh else 0,
                vd=c // nh if nh else 0, w=mp["local_atten_len"],
                lookahead=mp["lookahead"])


def param_table(mp: dict) -> list:
    """(name, shape, offset, scale) of every weight: a weight is drawn
    as offset + scale * U(-1, 1). Matrices and their biases take
    1/sqrt(fan in), LayerNorm gains 1 +- 0.1, shifts +- 0.1, PReLU
    slopes 0.25 +- 0.05. The names are the model's state-dict keys."""
    d = dims(mp)
    c, h, f, nh, e, vd = d["C"], d["H"], d["F"], d["nh"], d["e"], d["vd"]
    rows = []

    def dense(name, n_in, n_out):
        s = 1.0 / math.sqrt(n_in)
        rows.extend([(f"{name}.weight", (n_out, n_in), 0.0, s),
                     (f"{name}.bias", (n_out,), 0.0, s)])

    def norm(name, n):
        rows.extend([(f"{name}.weight", (n,), 1.0, 0.1),
                     (f"{name}.bias", (n,), 0.0, 0.1)])

    def lstm(name, n_in, suffixes):
        s = 1.0 / math.sqrt(h)
        for sfx in suffixes:
            rows.extend([(f"{name}.w_ih{sfx}", (4 * h, n_in), 0.0, s),
                         (f"{name}.w_hh{sfx}", (4 * h, h), 0.0, s),
                         (f"{name}.b_ih{sfx}", (4 * h,), 0.0, s),
                         (f"{name}.b_hh{sfx}", (4 * h,), 0.0, s)])

    s_conv = 1.0 / math.sqrt(2 * d["M"] * 9)
    rows.extend([("tfgridnet.conv.weight", (c, 2 * d["M"], 3, 3), 0.0,
                  s_conv), ("tfgridnet.conv.bias", (c,), 0.0, s_conv)])
    for i in range(d["B"]):
        p = f"tfgridnet.blocks.{i}"
        norm(f"{p}.intra_norm", c)
        lstm(f"{p}.intra_rnn", c, ("_l0", "_l0_reverse"))
        dense(f"{p}.intra_linear", 2 * h, c)
        norm(f"{p}.inter_norm", c)
        lstm(f"{p}.inter_rnn", c, ("_l0",))
        dense(f"{p}.inter_linear", h, c)
        if nh:
            for name, n_out, n_norm in (("attn_q", e * nh, f * e),
                                        ("attn_k", e * nh, f * e),
                                        ("attn_v", vd * nh, f * vd),
                                        ("attn_proj", c, f * c)):
                n_in = nh * vd if name == "attn_proj" else c
                dense(f"{p}.{name}.dense", n_in, n_out)
                rows.append((f"{p}.{name}.act.weight", (1,), 0.25, 0.05))
                norm(f"{p}.{name}.norm", n_norm)
    dense("tfgridnet.embed_proj_dense", d["E"], c * f)
    norm("tfgridnet.embed_proj_norm", c * f)
    s_dec = 1.0 / math.sqrt(c * 9)
    rows.extend([("tfgridnet.deconv.weight", (2 * d["S"], c, 3, 3), 0.0,
                  s_dec), ("tfgridnet.deconv.bias", (2 * d["S"],), 0.0,
                           s_dec)])
    return rows


def filterbank(nfft: int, hop: int) -> np.ndarray:
    """The [2F, nfft] analysis and synthesis filterbank (asteroid's
    STFTFB): the real and imaginary rows of the DFT, scaled by
    1 / (0.5 sqrt(nfft * nfft / hop)), the DC and Nyquist rows by a
    further 1 / sqrt(2), times the sqrt-Hann window."""
    f = nfft // 2 + 1
    dft = np.fft.fft(np.eye(nfft)) / (0.5 * np.sqrt(nfft * nfft / hop))
    fb = np.vstack([np.real(dft[:f]), np.imag(dft[:f])])
    fb[0] /= np.sqrt(2)
    fb[nfft // 2] /= np.sqrt(2)
    return (fb * np.hanning(nfft + 1)[:-1] ** 0.5).astype(np.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with a per-tensor scale."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class Reference:
    """The separator's weights `p` ({name: float32 tensor}) and sizes;
    `frames` runs a block of frames."""

    def __init__(self, mp: dict, params: dict, mode: str = "f32",
                 kv_int8: bool = False, loop_lstm: bool = False):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode}")
        self.d = dims(mp)
        self.p = params
        self.kv_int8 = kv_int8
        self.loop_lstm = loop_lstm
        self._lstms: dict = {}
        self.q = fp8 if mode == "fp8" else (lambda x: x)
        dev = next(iter(params.values())).device
        self.fb = torch.from_numpy(filterbank(self.d["nfft"],
                                              self.d["hop"])).to(dev)

    # -- products ---------------------------------------------------------

    def linear(self, x, name):
        return self.q(x) @ self.q(self.p[name + ".weight"]).T \
            + self.p[name + ".bias"]

    def layer_norm(self, x, name, n_dims: int = 1):
        dims_ = tuple(range(-n_dims, 0))
        var, mu = torch.var_mean(x, dim=dims_, keepdim=True, correction=0)
        shape = x.shape[-n_dims:]
        return (x - mu) / torch.sqrt(var + 1e-5) * \
            self.p[name + ".weight"].reshape(shape) + \
            self.p[name + ".bias"].reshape(shape)

    def prelu(self, x, name):
        return torch.where(x >= 0, x, self.p[name + ".weight"] * x)

    def lstm(self, x, name, suffixes, h0=None, c0=None):
        """x [N, T, I]; one direction per suffix, the second over time
        reversed. Returns (y [N, T, D*H], h_T, c_T), the carries
        [D, N, H]. `torch.nn.LSTM` (cuDNN on the card, TF32 as the
        caller sets it) with these weights, or with `loop_lstm` an
        explicit loop over time, whose products a flop counter sees."""
        q = self.q
        n, t, i_dim = x.shape
        hid, nd = self.d["H"], len(suffixes)
        if h0 is None:
            h0 = c0 = x.new_zeros((nd, n, hid))
        weights = {}
        for sfx in suffixes:
            for ours, torchs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                w = self.p[f"{name}.{ours}{sfx}"]
                weights[torchs + sfx] = q(w) if ours[0] == "w" else w
        if not self.loop_lstm:
            key = (i_dim, nd)
            if key not in self._lstms:
                self._lstms[key] = torch.nn.LSTM(
                    i_dim, hid, batch_first=True, bidirectional=nd == 2,
                    device=x.device)
            y, (h, c) = torch.func.functional_call(
                self._lstms[key], weights, (q(x), (h0, c0)))
            return y, h, c
        xp = torch.stack([
            (q(x.flip(1) if j else x) @ weights["weight_ih" + s].T
             + weights["bias_ih" + s] + weights["bias_hh" + s])
            for j, s in enumerate(suffixes)])               # [D, N, T, 4H]
        w_t = torch.stack([weights["weight_hh" + s].T for s in suffixes])
        h, c = h0, c0
        ys = []
        for step in range(t):
            g = xp[:, :, step] + torch.bmm(q(h), w_t)
            i, f, gg, o = g.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        y = torch.stack(ys, dim=2)                          # [D, N, T, H]
        y = torch.cat([y[0], y[1].flip(1)], dim=-1) if nd == 2 else y[0]
        return y, h, c

    def int8_round_trip(self, x):
        """x [rows, T, F*dim] through int8 per (row, frame, head) over
        (f, dim); rows are (batch, head)."""
        s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
        return torch.clamp(torch.round(x / s), -127, 127) * s

    def attention(self, z, st, name):
        """z [B, T, F, C] -> the attention branch [B, T, F, C]; the
        carried keys and values of the w-1 previous frames in `st`."""
        q_ = self.q
        b, t, f, c = z.shape
        nh, e, vd, w = self.d["nh"], self.d["e"], self.d["vd"], self.d["w"]

        def heads(proj, dim):
            y = self.prelu(self.linear(z, f"{name}.{proj}.dense"),
                           f"{name}.{proj}.act")
            y = y.reshape(b, t, f, nh, dim).permute(0, 3, 1, 2, 4)
            y = y.reshape(b * nh, t, f * dim)
            return self.layer_norm(y, f"{name}.{proj}.norm")

        qh, kh, vh = heads("attn_q", e), heads("attn_k", e), \
            heads("attn_v", vd)
        kq = self.int8_round_trip(kh) if self.kv_int8 else kh
        vq = self.int8_round_trip(vh) if self.kv_int8 else vh
        k_hist = torch.cat([st["k"], kq], dim=1)           # [R, w-1+T, .]
        v_hist = torch.cat([st["v"], vq], dim=1)
        st["k"], st["v"] = k_hist[:, t:], v_hist[:, t:]
        scale = 1.0 / math.sqrt(f * e)
        outs = []
        for t0 in range(0, t, ATTN_QUERIES):
            t1 = min(t, t0 + ATTN_QUERIES)
            # query t0 + i sees history rows t0 + i .. t0 + i + w - 2,
            # then itself
            kw = torch.cat([k_hist[:, t0:t1 + w - 2].unfold(1, w - 1, 1),
                            kh[:, t0:t1, :, None]], dim=-1)  # [R, TQ, ., w]
            vw = torch.cat([v_hist[:, t0:t1 + w - 2].unfold(1, w - 1, 1),
                            vh[:, t0:t1, :, None]], dim=-1)
            s = torch.einsum("rtd,rtdw->rtw", q_(qh[:, t0:t1]), q_(kw))
            a = torch.softmax(s * scale, dim=-1)
            outs.append(torch.einsum("rtw,rtdw->rtd", q_(a), q_(vw)))
        out = torch.cat(outs, dim=1)                        # [R, T, F*vd]
        out = out.reshape(b, nh, t, f, vd).permute(0, 2, 3, 1, 4)
        out = out.reshape(b, t, f, nh * vd)
        p = self.prelu(self.linear(out, f"{name}.attn_proj.dense"),
                       f"{name}.attn_proj.act")
        p = self.layer_norm(p.reshape(b, t, f * c),
                            f"{name}.attn_proj.norm")
        return p.reshape(b, t, f, c)

    def block(self, x, st, i):
        """One GridNet block: x [B, C, T, F] -> [B, C, T, F]."""
        name = f"tfgridnet.blocks.{i}"
        b, c, t, f = x.shape
        inp = x.permute(0, 2, 3, 1)                         # [B, T, F, C]
        y = self.layer_norm(inp, f"{name}.intra_norm")
        y, _, _ = self.lstm(y.reshape(b * t, f, c), f"{name}.intra_rnn",
                            ("_l0", "_l0_reverse"))
        y = self.linear(y, f"{name}.intra_linear").reshape(b, t, f, c) + inp
        z = self.layer_norm(y, f"{name}.inter_norm")
        z = z.transpose(1, 2).reshape(b * f, t, c)
        z, st["h"], st["c"] = self.lstm(z, f"{name}.inter_rnn", ("_l0",),
                                        st["h"], st["c"])
        z = self.linear(z, f"{name}.inter_linear")
        z = z.reshape(b, f, t, c).transpose(1, 2) + y
        if self.d["nh"]:
            z = z + self.attention(z, st, name)
        return z.permute(0, 3, 1, 2)

    # -- the model --------------------------------------------------------

    def init_state(self, batch: int) -> dict:
        d = self.d
        f, dev = d["F"], self.fb.device

        def zeros(*shape):
            return torch.zeros(shape, device=dev)
        blocks = []
        for _ in range(d["B"]):
            st = {"h": zeros(1, batch * f, d["H"]),
                  "c": zeros(1, batch * f, d["H"])}
            if d["nh"]:
                st["k"] = zeros(batch * d["nh"], d["w"] - 1, f * d["e"])
                st["v"] = zeros(batch * d["nh"], d["w"] - 1, f * d["vd"])
            blocks.append(st)
        return {"conv": zeros(batch, 2 * d["M"], 2, f),
                "deconv": zeros(batch, d["C"], 2, f),
                "istft": zeros(batch, d["S"], 1, d["nfft"]),
                "blocks": blocks}

    def frames(self, x, emb, state):
        """x [B, M, (T-1)*hop + nfft] audio of T analysis frames; emb
        [B, E]. Returns audio [B, S, T*hop], the output of each frame
        delayed by one hop, and updates `state` (a new tensor for each
        leaf)."""
        d, q = self.d, self.q
        b, f, hop, nfft = x.shape[0], d["F"], d["hop"], d["nfft"]
        fr = x.unfold(-1, nfft, hop)                        # [B, M, T, K]
        spec = torch.einsum("bmtk,fk->bmft", q(fr), q(self.fb))
        spec = torch.cat([spec[:, :, :f], spec[:, :, f:]], dim=1)
        spec = spec.transpose(2, 3)                         # [B, 2M, T, F]
        t = spec.shape[2]
        padded = torch.cat([state["conv"], spec], dim=2)
        state["conv"] = padded[:, :, -2:]
        h = nnf.conv2d(q(padded), q(self.p["tfgridnet.conv.weight"]),
                       self.p["tfgridnet.conv.bias"], padding=(0, 1))
        e = self.layer_norm(self.linear(emb, "tfgridnet.embed_proj_dense"),
                            "tfgridnet.embed_proj_norm")
        e = e.reshape(b, d["C"], 1, f)
        for i, st in enumerate(state["blocks"]):
            if i == 1:
                h = h * e
            h = self.block(h, st, i)
        padded = torch.cat([state["deconv"], h], dim=2)
        state["deconv"] = padded[:, :, -2:]
        y = nnf.conv2d(q(padded), q(self.p["tfgridnet.deconv.weight"]),
                       self.p["tfgridnet.deconv.bias"], padding=(0, 1))
        y = y.reshape(b, d["S"], 2, t, f).transpose(3, 4)
        y = torch.cat([y[:, :, 0], y[:, :, 1]], dim=2)      # [B, S, 2F, T]
        out = torch.einsum("bsft,fk->bstk", q(y), q(self.fb))
        out = torch.cat([state["istft"], out], dim=2)
        state["istft"] = out[:, :, -1:]
        return overlap_add(out, hop)[..., hop:hop + t * hop]

    def utterance(self, x, emb):
        """The whole-utterance forward of `Net.forward`: x [B, M, N]
        padded to whole chunks plus the lookahead, output cut to N."""
        d = self.d
        n = x.shape[-1]
        pad = (-n) % d["hop"] + (d["nfft"] - d["hop"] if d["lookahead"]
                                 else 0)
        y = self.frames(nnf.pad(x, (0, pad)), emb,
                        self.init_state(x.shape[0]))
        return y[..., :n]


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """[..., T, K] frames, hop apart -> [..., (T-1)*hop + K] samples."""
    *lead, t, k = frames.shape
    n_chunks = -(-k // hop)
    frames = nnf.pad(frames, (0, n_chunks * hop - k))
    frames = frames.reshape(*lead, t, n_chunks, hop)
    out = frames.new_zeros((*lead, (t + n_chunks) * hop))
    for j in range(n_chunks):
        out[..., j * hop:(j + t) * hop] = out[..., j * hop:(j + t) * hop] \
            + frames[..., j, :].reshape(*lead, t * hop)
    return out[..., :(t - 1) * hop + k]


# -- the entry points of the loops (`benchmark/harness/<kind>.py`) --------

def serve_outputs(mp, params, pool, emb, sample, frames, kv_int8,
                  device, mode="f32") -> np.ndarray:
    """The reference's output of `frames` frames for the streams
    `sample`: [len(sample), frames, S, hop]. The streams' audio is the
    pool's chunks in the order the loop fed them: frame j is chunk j
    followed by the lookahead of chunk j + 1."""
    d = dims(mp)
    hop, nfft = d["hop"], d["nfft"]
    n_pool = len(pool)
    idx = np.arange(frames + 1) % n_pool
    x = pool[:, sample][idx]                   # [frames+1, s, M, hop]
    x = torch.from_numpy(np.ascontiguousarray(
        x.transpose(1, 2, 0, 3).reshape(len(sample), d["M"], -1))).to(device)
    e = torch.from_numpy(emb[sample]).to(device)
    p32 = {k: v.float() for k, v in params.items()}
    out = []
    with torch.no_grad(), precision(mode):
        ref = Reference(mp, p32, mode=mode, kv_int8=kv_int8)
        state = ref.init_state(len(sample))
        for f0 in range(0, frames, REF_FRAMES):
            f1 = min(frames, f0 + REF_FRAMES)
            seg = x[..., f0 * hop:(f1 - 1) * hop + nfft]
            out.append(ref.frames(seg, e, state).cpu())
    y = torch.cat(out, dim=-1).numpy()             # [s, S, frames*hop]
    return y.reshape(len(sample), d["S"], frames, hop).transpose(0, 2, 1, 3)

