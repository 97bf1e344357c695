"""CDPAM perceptual audio distance on tensors (counterpart of
`lookoncetohear_tpu/losses/cdpam.py`, which re-derives the `cdpam`
package's network from the paper: Manocha et al., "CDPAM: Contrastive
learning and multi-dimensional representations for robust audio
similarity", ICASSP 2021).

* Input: mono waveforms, resampled to 22 050 Hz and scaled to the int16
  range, as the package's loader feeds them.
* Encoder (`CDPAMEncoder`): 16 strided 1-D convolutions over the raw
  waveform, kernel 3, 'SAME' padding as XLA pads it, stride 2 on every
  other layer, 64 channels doubling every 5 layers up to 512, each
  followed by BatchNorm (running statistics) and LeakyReLU(0.2), then a
  mean over time; two MLP heads 512 -> 512 -> 256, the acoustic
  embedding the distance is defined on and the content embedding (kept
  for the checkpoint's shapes, unused by the distance).
* Distance: the squared distance between L2-normalized acoustic
  embeddings, averaged over the batch.

Weights: `weights=` or $LOOKONCE_CDPAM_WEIGHTS names an `.npz` in the
JAX package's layout (`params/conv_0/kernel` [k, in, out], ...,
`batch_stats/bn_0/mean`) or a torch state_dict of the `cdpam` package,
mapped by `load_torch_state`. The pretrained file is not in the
repository; without one the network is a seeded random one, and
`LossFn("cdpam")` refuses it unless asked with `allow_random=True`.
`load_jax_state` carries a JAX `CDPAM`'s params and batch stats over.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

CDPAM_SR = 22050
_WEIGHTS_ENV = "LOOKONCE_CDPAM_WEIGHTS"


def resample_fft(x: torch.Tensor, sr_in: int, sr_out: int) -> torch.Tensor:
    """Band-limited (FFT) resampling along the last axis, scipy
    `resample` semantics, differentiable. x: [..., T] ->
    [..., round(T * sr_out / sr_in)]."""
    if sr_in == sr_out:
        return x
    t = x.shape[-1]
    n_out = int(round(t * sr_out / sr_in))
    spec = torch.fft.rfft(x, dim=-1)
    n_bins_out = n_out // 2 + 1
    if n_bins_out <= spec.shape[-1]:
        spec = spec[..., :n_bins_out]
    else:
        spec = nn.functional.pad(spec, (0, n_bins_out - spec.shape[-1]))
    return torch.fft.irfft(spec, n=n_out, dim=-1) * (n_out / t)


def _same_pad(n: int, stride: int, k: int = 3) -> tuple[int, int]:
    """XLA's 'SAME' padding of a length-n axis: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class CDPAMEncoder(nn.Module):
    """Strided 1-D conv encoder + acoustic / content projection heads."""

    def __init__(self, n_layers: int = 16, base_filters: int = 64,
                 acoustic_dim: int = 256, content_dim: int = 256,
                 proj_hidden: int = 512):
        super().__init__()
        self.n_layers = n_layers
        chans = [base_filters * 2 ** (i // 5) for i in range(n_layers)]
        self.strides = [2 if i % 2 == 1 else 1 for i in range(n_layers)]
        self.convs = nn.ModuleList(
            nn.Conv1d(c_in, c_out, 3, stride=s)
            for c_in, c_out, s in zip([1] + chans[:-1], chans,
                                      self.strides))
        # flax's BatchNorm epsilon
        self.bns = nn.ModuleList(nn.BatchNorm1d(c, eps=1e-5) for c in chans)
        self.heads = nn.ModuleDict({
            f"{name}_fc{j}": nn.Linear(d_in, d_out)
            for name, out_dim in (("acoustic", acoustic_dim),
                                  ("content", content_dim))
            for j, (d_in, d_out) in enumerate(((chans[-1], proj_hidden),
                                               (proj_hidden, out_dim)))})
        # flax's initializers: LeCun normal (truncated at 2 std) weights,
        # zero biases
        for m in [*self.convs, *self.heads.values()]:
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor):
        """x: [B, T] raw 22.05 kHz audio (int16 float range) ->
        (acoustic [B, acoustic_dim], content [B, content_dim])."""
        h = x[:, None, :]
        for conv, bn, s in zip(self.convs, self.bns, self.strides):
            h = conv(nn.functional.pad(h, _same_pad(h.shape[-1], s)))
            h = nn.functional.leaky_relu(bn(h), 0.2)
        h = h.mean(dim=-1)

        def head(name):
            y = torch.relu(self.heads[f"{name}_fc0"](h))
            return self.heads[f"{name}_fc1"](y)
        return head("acoustic"), head("content")


class CDPAM:
    """The perceptual distance d(x, y) = mean_B || a(x) - a(y) ||^2 with
    a(.) the L2-normalized acoustic embedding. The network follows its
    input's device and keeps no gradient of its own weights."""

    def __init__(self, weights: str | None = None,
                 input_sr: int = 16000, seed: int = 0) -> None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.encoder = CDPAMEncoder()
        self.encoder.eval().requires_grad_(False)
        self.input_sr = input_sr
        self.pretrained = False
        path = weights or os.environ.get(_WEIGHTS_ENV)
        if path and os.path.exists(path):
            self._load(path)
            self.pretrained = True
        else:
            logging.warning(
                "cdpam: no pretrained weights (%s unset/missing) — "
                "using random init; the distance is structurally valid "
                "but perceptually untrained", _WEIGHTS_ENV)

    # -- weights, in the JAX package's flat layout ------------------------

    def flat_state(self) -> Dict[str, np.ndarray]:
        """{'params/conv_0/kernel': [k, in, out], ..., 'batch_stats/
        bn_0/mean': ...}: the JAX `CDPAM.save` layout."""
        enc, out = self.encoder, {}
        for i, (conv, bn) in enumerate(zip(enc.convs, enc.bns)):
            out[f"params/conv_{i}/kernel"] = conv.weight.permute(2, 1, 0)
            out[f"params/conv_{i}/bias"] = conv.bias
            out[f"params/bn_{i}/scale"] = bn.weight
            out[f"params/bn_{i}/bias"] = bn.bias
            out[f"batch_stats/bn_{i}/mean"] = bn.running_mean
            out[f"batch_stats/bn_{i}/var"] = bn.running_var
        for name, lin in enc.heads.items():
            out[f"params/{name}/kernel"] = lin.weight.t()
            out[f"params/{name}/bias"] = lin.bias
        return {k: v.detach().cpu().numpy().copy() for k, v in out.items()}

    def load_flat(self, flat: Dict[str, Any]) -> None:
        """Load every tensor of `flat_state`'s layout (strict)."""
        enc = self.encoder
        want = self.flat_state()
        if sorted(flat) != sorted(want):
            raise ValueError(f"CDPAM state keys differ: missing "
                             f"{sorted(set(want) - set(flat))}, unexpected "
                             f"{sorted(set(flat) - set(want))}")
        t = {k: torch.tensor(np.asarray(v), dtype=torch.float32)
             for k, v in flat.items()}
        with torch.no_grad():
            for i, (conv, bn) in enumerate(zip(enc.convs, enc.bns)):
                conv.weight.copy_(t[f"params/conv_{i}/kernel"].permute(
                    2, 1, 0))
                conv.bias.copy_(t[f"params/conv_{i}/bias"])
                bn.weight.copy_(t[f"params/bn_{i}/scale"])
                bn.bias.copy_(t[f"params/bn_{i}/bias"])
                bn.running_mean.copy_(t[f"batch_stats/bn_{i}/mean"])
                bn.running_var.copy_(t[f"batch_stats/bn_{i}/var"])
            for name, lin in enc.heads.items():
                lin.weight.copy_(t[f"params/{name}/kernel"].t())
                lin.bias.copy_(t[f"params/{name}/bias"])

    def load_jax_state(self, params: dict, batch_stats: dict) -> None:
        """A JAX `CDPAM`'s `params` and `batch_stats` (nested dicts of
        arrays, converted with numpy) into this network."""
        flat = {f"params/{k}": v for k, v in _flatten(params).items()}
        flat.update({f"batch_stats/{k}": v
                     for k, v in _flatten(batch_stats).items()})
        self.load_flat({k: np.asarray(v) for k, v in flat.items()})

    def _load(self, path: str) -> None:
        if path.endswith(".npz"):
            with np.load(path) as z:
                self.load_flat(dict(z))
        else:
            self.load_torch_state(path)

    def save(self, path: str) -> None:
        np.savez(path, **self.flat_state())

    def load_torch_state(self, path: str) -> None:
        """Map a torch CDPAM state_dict onto this network, as the JAX
        package maps it onto its own.

        Conv / Linear weights are matched by shape in encounter order
        against candidate lists built once and consumed as they match (so
        the many same-shape 64 -> 64 convs each get a distinct tensor).
        Biases and BatchNorm gamma / beta / mean / var are keyed by the
        torch module prefix of the tensor they belong to (the conv's
        sibling `.bias`; the next unconsumed BN module of the conv's
        output width), never by bare shape. Raises if a kernel or a BN
        module present in the checkpoint does not map."""
        sd = torch.load(path, map_location="cpu")
        if isinstance(sd, dict) and "state" in sd:
            sd = sd["state"]

        def prefix_of(key: str, suffix: str) -> str:
            # "enc.conv0.weight" -> "enc.conv0"; bare "weight" -> ""
            return key[: -len(suffix)].rstrip(".")

        convs = [(prefix_of(k, "weight"), v) for k, v in sd.items()
                 if v.ndim == 3 and k.endswith("weight")]
        lins = [(prefix_of(k, "weight"), v) for k, v in sd.items()
                if v.ndim == 2 and k.endswith("weight")]
        bns = [prefix_of(k, "running_mean") for k, v in sd.items()
               if k.endswith("running_mean") and v.ndim == 1]

        def sib(prefix: str, leaf: str):
            return sd.get(f"{prefix}.{leaf}" if prefix else leaf)

        flat = self.flat_state()
        p = {k[len("params/"):]: v for k, v in flat.items()
             if k.startswith("params/")}
        bs = {k[len("batch_stats/"):]: v for k, v in flat.items()
              if k.startswith("batch_stats/")}
        loaded: list = []
        missing: list = []

        for i in range(self.encoder.n_layers):
            wk = f"conv_{i}/kernel"
            want = p[wk].shape  # [k, in, out]
            idx = next((j for j, (_, v) in enumerate(convs)
                        if tuple(v.shape) == (want[2], want[1],
                                              want[0])), None)
            if idx is None:
                raise ValueError(
                    f"no unconsumed torch conv matches layer {i} "
                    f"(flax kernel shape {want})")
            cpfx, w = convs.pop(idx)
            p[wk] = np.transpose(w.numpy(), (2, 1, 0))
            loaded.append(wk)
            tb = sib(cpfx, "bias")
            if tb is not None and tb.ndim == 1 and tb.shape[0] == want[2]:
                p[f"conv_{i}/bias"] = tb.numpy()
                loaded.append(f"conv_{i}/bias")
            else:  # Conv1d(bias=False) before BN: a zero bias
                p[f"conv_{i}/bias"] = np.zeros(want[2], np.float32)
            # sibling BatchNorm: the next unconsumed BN of this width
            bidx = next(
                (j for j, bp in enumerate(bns)
                 if sib(bp, "running_mean").shape[0] == want[2]), None)
            if bidx is not None:
                bp = bns.pop(bidx)
                for leaf, tree, tv in (("scale", p, sib(bp, "weight")),
                                       ("bias", p, sib(bp, "bias")),
                                       ("mean", bs, sib(bp, "running_mean")),
                                       ("var", bs, sib(bp, "running_var"))):
                    if tv is not None:
                        tree[f"bn_{i}/{leaf}"] = tv.numpy()
                        loaded.append(f"bn_{i}/{leaf}")
            elif bns or any(k.endswith("running_mean") for k in sd):
                missing.append(f"bn_{i} (no BN of width {want[2]})")

        for hk in sorted(k for k in p if k.endswith("fc0/kernel")
                         or k.endswith("fc1/kernel")):
            want = p[hk].shape  # [in, out]
            idx = next((j for j, (_, v) in enumerate(lins)
                        if tuple(v.shape) == (want[1], want[0])), None)
            if idx is None:
                missing.append(hk)
                continue
            lpfx, w = lins.pop(idx)
            p[hk] = w.numpy().T
            loaded.append(hk)
            tb = sib(lpfx, "bias")
            bk = hk[: -len("kernel")] + "bias"
            if tb is not None and tb.ndim == 1 and tb.shape[0] == want[1]:
                p[bk] = tb.numpy()
                loaded.append(bk)

        if missing:
            raise ValueError(
                f"torch CDPAM checkpoint did not cover: {missing} "
                f"(loaded {len(loaded)} tensors)")
        logging.info("cdpam: loaded %d tensors from %s "
                     "(%d convs / %d linears left unconsumed)",
                     len(loaded), path, len(convs), len(lins))
        self.load_flat({**{f"params/{k}": v for k, v in p.items()},
                        **{f"batch_stats/{k}": v for k, v in bs.items()}})

    # -- distance ----------------------------------------------------------

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T] at self.input_sr -> L2-normalized acoustic
        embedding [B, acoustic_dim]."""
        self.encoder.to(x.device)
        x = resample_fft(x.float(), self.input_sr, CDPAM_SR) * 32768.0
        a, _ = self.encoder(x)
        return a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
                    + 1e-8)

    def __call__(self, est: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """est / gt: [B, T] rows -> the scalar mean distance."""
        return ((self.embed(gt) - self.embed(est)) ** 2).sum(-1).mean()


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out
