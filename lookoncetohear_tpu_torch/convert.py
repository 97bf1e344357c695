"""The reference's PyTorch checkpoints -> the port's models (counterpart
of `lookoncetohear_tpu/convert.py`).

A Lightning `.ckpt`'s `state_dict` (keys under `model.`) of the
reference's streaming TSE network or its enrollment net converts,
weight for weight, into a `state_dict` of the port's `Net` or
`EmbedNet`. The conversion composes the JAX converter's numpy layout
rules (copied here: that module is the JAX package's) with the flax ->
port rules of `weights.params_from_jax`:

  torch Linear weight [out, in]        -> dense kernel = weight.T
  torch LSTM weight_*/bias_*           -> identical layout
  torch Conv2d weight [out, in, kh, kw]-> flax kernel [kh, kw, in, out]
  torch ConvTranspose2d [in, out, kh, kw], stride 1, padding p
      == a conv with the kernel flipped in (kh, kw), in/out swapped,
         padding (k-1-p)   (the models' deconv)
  torch PReLU weight [1]               -> alpha
  torch LayerNorm weight/bias          -> scale/bias
  espnet LayerNormalization4D/4DCF gamma/beta -> identical

    from lookoncetohear_tpu_torch.convert import (load_reference,
                                                  load_torch_checkpoint)
    load_reference(net, load_torch_checkpoint("epoch=99.ckpt"))
"""

from __future__ import annotations

import re

import numpy as np
import torch

from lookoncetohear_tpu_torch.weights import flatten_params, params_from_jax


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _conv2d(w) -> np.ndarray:
    """[out, in, kh, kw] -> [kh, kw, in, out]."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _deconv2d(w) -> np.ndarray:
    """ConvTranspose2d [in, out, kh, kw] -> the equivalent conv kernel
    [kh, kw, in, out] (spatially flipped)."""
    w = np.asarray(w)[:, :, ::-1, ::-1]
    return np.transpose(w, (2, 3, 0, 1))


def load_torch_checkpoint(path: str) -> dict:
    """A Lightning/torch .ckpt -> {key: numpy array} (its `state_dict`,
    or the file itself when it holds none)."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = ck.get("state_dict", ck)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _lstm(sd: dict, prefix: str, bidirectional: bool) -> dict:
    keys = ["w_ih_l0", "w_hh_l0", "b_ih_l0", "b_hh_l0"]
    tkeys = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    out = {k: np.asarray(sd[f"{prefix}.{tk}"])
           for k, tk in zip(keys, tkeys)}
    if bidirectional:
        out.update({f"{k}_reverse": np.asarray(sd[f"{prefix}.{tk}_reverse"])
                    for k, tk in zip(keys, tkeys)})
    return out


def _attn_proj(sd: dict, prefix: str) -> dict:
    """The streaming net's attention Sequential: 0 Linear, 1 PReLU,
    3 LayerNorm."""
    return {
        "dense": {"kernel": _t(sd[f"{prefix}.0.weight"]),
                  "bias": np.asarray(sd[f"{prefix}.0.bias"])},
        "act": {"alpha": np.asarray(sd[f"{prefix}.1.weight"]).reshape(1)},
        "norm": {"scale": np.asarray(sd[f"{prefix}.3.norm.weight"]),
                 "bias": np.asarray(sd[f"{prefix}.3.norm.bias"])},
    }


def convert_tse_state_dict(sd: dict, n_layers: int = 3,
                           use_attn: bool = True) -> dict:
    """The reference streaming TSE model's state_dict -> the JAX
    package's nested params of `models.net.Net`."""
    if any(k.startswith("model.") for k in sd):
        sd = _strip(sd, "model.")
    sd = _strip(sd, "tfgridnet.")
    g: dict = {
        "conv": {"kernel": _conv2d(sd["conv.0.weight"]),
                 "bias": np.asarray(sd["conv.0.bias"])},
        "deconv": {"kernel": _deconv2d(sd["deconv.weight"]),
                   "bias": np.asarray(sd["deconv.bias"])},
        "embed_proj_dense": {
            "kernel": _t(sd["embed_to_feats_proj.0.weight"]),
            "bias": np.asarray(sd["embed_to_feats_proj.0.bias"])},
        "embed_proj_norm": {
            "scale": np.asarray(sd["embed_to_feats_proj.1.weight"]),
            "bias": np.asarray(sd["embed_to_feats_proj.1.bias"])},
    }
    for i in range(n_layers):
        b = f"blocks.{i}"
        blk = {
            "intra_norm": {
                "scale": np.asarray(sd[f"{b}.intra_norm.norm.weight"]),
                "bias": np.asarray(sd[f"{b}.intra_norm.norm.bias"])},
            "intra_rnn": _lstm(sd, f"{b}.intra_rnn", True),
            "intra_linear": {
                "kernel": _t(sd[f"{b}.intra_linear.weight"]),
                "bias": np.asarray(sd[f"{b}.intra_linear.bias"])},
            "inter_norm": {
                "scale": np.asarray(sd[f"{b}.inter_norm.norm.weight"]),
                "bias": np.asarray(sd[f"{b}.inter_norm.norm.bias"])},
            "inter_rnn": _lstm(sd, f"{b}.inter_rnn", False),
            "inter_linear": {
                "kernel": _t(sd[f"{b}.inter_linear.weight"]),
                "bias": np.asarray(sd[f"{b}.inter_linear.bias"])},
        }
        if use_attn:
            blk["attn_q"] = _attn_proj(sd, f"{b}.attn_conv_Q")
            blk["attn_k"] = _attn_proj(sd, f"{b}.attn_conv_K")
            blk["attn_v"] = _attn_proj(sd, f"{b}.attn_conv_V")
            blk["attn_proj"] = _attn_proj(sd, f"{b}.attn_concat_proj")
        g[f"blocks_{i}"] = blk
    return {"tfgridnet": g}


def _head_conv(sd: dict, prefix: str) -> dict:
    """The enrollment net's per-head Sequential: 0 Conv2d 1x1, 1 PReLU,
    2 LayerNormalization4DCF (gamma / beta)."""
    w = np.asarray(sd[f"{prefix}.0.weight"])  # [out, in, 1, 1]
    return {
        "kernel": _t(w[:, :, 0, 0]),
        "bias": np.asarray(sd[f"{prefix}.0.bias"]),
        "act": {"alpha": np.asarray(sd[f"{prefix}.1.weight"]).reshape(1)},
        "norm": {"gamma": np.asarray(sd[f"{prefix}.2.gamma"]),
                 "beta": np.asarray(sd[f"{prefix}.2.beta"])},
    }


def convert_embed_state_dict(sd: dict, n_layers: int = 3,
                             n_head: int = 4) -> dict:
    """The reference EmbedTFGridNet's state_dict -> the JAX package's
    nested params of `models.net.EmbedNet`."""
    if any(k.startswith("model.") for k in sd):
        sd = _strip(sd, "model.")
    trunk: dict = {
        "conv": {"kernel": _conv2d(sd["conv.0.weight"]),
                 "bias": np.asarray(sd["conv.0.bias"])},
        "conv_norm": {
            "scale": np.asarray(sd["conv.1.weight"]).reshape(1, -1, 1, 1),
            "bias": np.asarray(sd["conv.1.bias"]).reshape(1, -1, 1, 1)},
    }
    for i in range(n_layers):
        b = f"blocks.{i}"
        blk = {
            "intra_norm": {"gamma": np.asarray(sd[f"{b}.intra_norm.gamma"]),
                           "beta": np.asarray(sd[f"{b}.intra_norm.beta"])},
            "intra_rnn": _lstm(sd, f"{b}.intra_rnn", True),
            "intra_linear": {
                "weight": np.asarray(sd[f"{b}.intra_linear.weight"]),
                "bias": np.asarray(sd[f"{b}.intra_linear.bias"])},
            "inter_norm": {"gamma": np.asarray(sd[f"{b}.inter_norm.gamma"]),
                           "beta": np.asarray(sd[f"{b}.inter_norm.beta"])},
            "inter_rnn": _lstm(sd, f"{b}.inter_rnn", True),
            "inter_linear": {
                "weight": np.asarray(sd[f"{b}.inter_linear.weight"]),
                "bias": np.asarray(sd[f"{b}.inter_linear.bias"])},
            "attn_concat_proj": _head_conv(sd, f"{b}.attn_concat_proj"),
        }
        for h in range(n_head):
            blk[f"attn_q_{h}"] = _head_conv(sd, f"{b}.attn_conv_Q_{h}")
            blk[f"attn_k_{h}"] = _head_conv(sd, f"{b}.attn_conv_K_{h}")
            blk[f"attn_v_{h}"] = _head_conv(sd, f"{b}.attn_conv_V_{h}")
        trunk[f"blocks_{i}"] = blk
    return {"net": {
        "trunk": trunk,
        "embed_proj_dense": {"kernel": _t(sd["embed_proj.0.weight"]),
                             "bias": np.asarray(sd["embed_proj.0.bias"])},
        "embed_proj_norm": {"scale": np.asarray(sd["embed_proj.1.weight"]),
                            "bias": np.asarray(sd["embed_proj.1.bias"])},
    }}


def reference_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """A reference state_dict (streaming TSE or enrollment net, told
    apart by its keys; block and head counts read from them) -> the
    port's `state_dict` of `Net` or `EmbedNet`, float32 CPU tensors."""
    sd = _strip(sd, "model.") if any(k.startswith("model.") for k in sd) \
        else sd
    blocks = {int(m.group(1)) for k in sd
              for m in [re.search(r"blocks\.(\d+)\.", k)] if m}
    n_layers = max(blocks) + 1 if blocks else 0
    if any(k.startswith("tfgridnet.") for k in sd):
        tree = convert_tse_state_dict(
            sd, n_layers, use_attn=any(".attn_conv_Q." in k for k in sd))
    else:
        heads = {int(m.group(1)) for k in sd
                 for m in [re.search(r"blocks\.0\.attn_conv_Q_(\d+)\.", k)]
                 if m}
        tree = convert_embed_state_dict(sd, n_layers, n_head=len(heads))
    return params_from_jax(flatten_params(tree))


def load_reference(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """Load a reference state_dict (`load_torch_checkpoint`'s) into the
    port's `Net` or `EmbedNet` strictly: every key maps to a parameter
    of the same shape, and every parameter is loaded."""
    model.load_state_dict(reference_state_dict(sd), strict=True)
    return model
