"""Normalization layers (counterpart of
`lookoncetohear_tpu/ops/norms.py`).

The flat forms are the serving forms of the streaming step: the
statistics are the one-pass E[x^2] - mu^2 in float32 over the flat
[B, D] projection layout, cast back to the input dtype, as in the JAX
package. `flat_head_layer_norm` (per (row, head), as products with a
0/1 segment matrix) and `flat_layer_norm_reference` (whole rows) are
their plain versions. The streaming step calls `flat_layer_norm` and,
for the fused Q/K/V projection, `flat_qkv_layer_norm`: on a CUDA tensor
both launch the segmented-row kernel (`csrc/flat_norm.cu`,
`flat_norm_cuda`), on a CPU tensor the plain versions.

`EspnetLayerNorm4D`, `EspnetLayerNorm4DCF` and `GroupNorm1` are the
offline TF-GridNet's norms on [B, C, T, F]: biased variance, eps inside
the square root, affine parameters shaped like the JAX package's
(`gamma`/`beta` [1, C, 1, 1] or [1, C, 1, F]; GroupNorm1's flax
`scale`/`bias` load as `weight`/`bias`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from lookoncetohear_tpu_torch import _build
# The JAX package's LayerNorm (flax scale/bias) and PReLU (one shared
# slope `alpha`, init 0.25) are written to match these two; the
# weights' names map in `weights.py`.
from torch.nn import LayerNorm, PReLU

__all__ = ["LayerNorm", "PReLU", "EspnetLayerNorm4D", "EspnetLayerNorm4DCF",
           "GroupNorm1", "head_segment_matrix", "flat_head_layer_norm",
           "flat_layer_norm", "flat_layer_norm_reference",
           "flat_qkv_layer_norm", "flat_norm_desc", "flat_norm_cuda"]


def normalize(x, dims, eps: float):
    """(x - mean) / sqrt(biased var + eps) over `dims`."""
    var, mu = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps)


class _AffineNorm4D(nn.Module):
    """Normalize [B, C, T, F] over `dims`, then scale and shift by
    parameters of `shape`."""

    dims: tuple = ()

    def __init__(self, shape, eps: float, names=("gamma", "beta")):
        super().__init__()
        self.eps = eps
        self._names = names
        self.register_parameter(names[0], nn.Parameter(torch.ones(shape)))
        self.register_parameter(names[1], nn.Parameter(torch.zeros(shape)))

    def forward(self, x):
        scale, shift = (getattr(self, n) for n in self._names)
        return normalize(x, self.dims, self.eps) * scale + shift


class EspnetLayerNorm4D(_AffineNorm4D):
    """espnet LayerNormalization4D: over C, (C,)-affine."""

    dims = (1,)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, 1), eps)


class EspnetLayerNorm4DCF(_AffineNorm4D):
    """espnet LayerNormalization4DCF: over (C, F), (C, F)-affine."""

    dims = (1, 3)

    def __init__(self, channels: int, freqs: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, freqs), eps)


class GroupNorm1(_AffineNorm4D):
    """torch GroupNorm(1, C): over (C, T, F), per-channel affine."""

    dims = (1, 2, 3)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, 1), eps, ("weight", "bias"))


def head_segment_matrix(d_flat: int, n_head: int, dim: int) -> np.ndarray:
    """[D, nh] 0/1 float32: flat (f, head, dim) column d belongs to head
    (d % (n_head*dim)) // dim."""
    col = np.arange(d_flat)
    head = (col % (n_head * dim)) // dim
    return (head[:, None] == np.arange(n_head)[None, :]).astype(np.float32)


def flat_head_layer_norm(y_flat, seg, n_per_head: float, scale_flat,
                         bias_flat, eps: float):
    """Per-(row, head) LayerNorm on flat (f, head, dim) columns: the plain
    version on any device (the JAX package's form).

    y_flat: [B, D]; seg: [D, nh] 0/1; scale/bias_flat: [D]. Returns
    y_flat's dtype."""
    x = y_flat.float()
    seg = seg.float()
    mu = (x @ seg) / n_per_head                           # [B, nh]
    m2 = ((x * x) @ seg) / n_per_head
    inv = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + eps)
    xn = (x - mu @ seg.T) * (inv @ seg.T)
    return (xn * scale_flat + bias_flat).to(y_flat.dtype)


def flat_layer_norm_reference(x_flat, scale_flat, bias_flat, eps: float):
    """Whole-row LayerNorm on [..., D], one-pass float32 statistics: the
    plain version on any device."""
    d = x_flat.shape[-1]
    x = x_flat.float()
    mu = x.sum(-1, keepdim=True) / d
    m2 = (x * x).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + eps)
    xn = (x - mu) * inv
    return (xn * scale_flat + bias_flat).to(x_flat.dtype)


def flat_layer_norm(x_flat, scale_flat, bias_flat, eps: float):
    """Whole-row LayerNorm on [B, D], one-pass float32 statistics: the
    kernel for a GPU tensor, the plain version for a CPU one. The kernel
    reads rows of unit stride: a row-strided view (the step's [F, C] view
    of a [1, C, 1, F] frame at one stream) is copied first."""
    if x_flat.device.type == "cpu":
        return flat_layer_norm_reference(x_flat, scale_flat, bias_flat, eps)
    if x_flat.dim() != 2:
        raise ValueError(f"flat_layer_norm takes [B, D] on the GPU, got "
                         f"{tuple(x_flat.shape)}")
    if x_flat.stride(1) != 1:
        x_flat = x_flat.contiguous()
    return flat_norm_cuda([(x_flat.unsqueeze(1), 1, scale_flat, bias_flat,
                            None, eps)])[0]


def flat_qkv_layer_norm(y, n_head: int, parts):
    """The per-(row, head) LayerNorms of a fused projection's column
    blocks, each after its PReLU.

    y: [B, F, C], the projection before its PReLUs; parts: ((dim, alpha,
    scale, bias, eps), ...), block i the next n_head * dim columns of
    each of the F groups, with the PReLU slope alpha (one element) and
    the [F * dim] affine its heads share. Returns one flat (f, head,
    dim) [B, F * n_head * dim] tensor a block, in y's dtype: one kernel
    launch for a GPU tensor (at most three blocks), the PReLU and
    `flat_head_layer_norm` for a CPU one."""
    b, f, _ = y.shape
    cols, col = [], 0
    for dim, *_ in parts:
        cols.append(y[..., col:col + n_head * dim])
        col += n_head * dim
    if y.device.type != "cpu":
        return flat_norm_cuda([(x, n_head, scale, bias, alpha, eps)
                               for x, (_, alpha, scale, bias, eps)
                               in zip(cols, parts)])
    outs = []
    for x, (dim, alpha, scale, bias, eps) in zip(cols, parts):
        x = torch.where(x >= 0, x, alpha * x)
        seg = torch.from_numpy(head_segment_matrix(f * n_head * dim, n_head,
                                                   dim))
        sc = scale.reshape(f, 1, dim).expand(f, n_head, dim).reshape(-1)
        bi = bias.reshape(f, 1, dim).expand(f, n_head, dim).reshape(-1)
        outs.append(flat_head_layer_norm(x.reshape(b, -1), seg,
                                         float(f * dim), sc, bi, eps))
    return outs


# the kernel's constants (csrc/flat_norm.cu): threads of a CTA, float32
# values a thread keeps, norms in one launch, the widest load in bytes
_THREADS = 256
_VALUES = 32
_MAX_DESCS = 3
_MAX_VEC_BYTES = 16


@dataclass(frozen=True)
class FlatNormDesc:
    """One norm of a `flat_norm_cuda` launch, as the kernel reads it:
    `rows` x `segs` segments, each normalised over its `groups` x
    `width` elements, element (r, g, s, w) at offset + r * row_stride +
    g * group_stride + s * width + w of the input's storage; `vec`
    elements a load, `team` threads a segment."""
    rows: int
    groups: int
    segs: int
    width: int
    row_stride: int
    group_stride: int
    offset: int
    vec: int
    team: int


def flat_norm_desc(rows: int, groups: int, segs: int, width: int,
                   row_stride: int, group_stride: int, offset: int,
                   elem_bytes: int) -> FlatNormDesc:
    """The kernel's descriptor of a [rows, groups, segs * width] view
    with those strides (its last one 1) at that storage offset, whose
    storage starts 16-byte aligned. `vec`: the widest load, up to 16
    bytes, that every segment's loads keep aligned; `team`: the
    smallest power of two whose threads take at most two loads each, up
    to a CTA. Raises when a thread would keep more than the kernel's
    registers hold."""
    vec = _MAX_VEC_BYTES // elem_bytes
    while vec > 1 and any(v % vec for v in (width, row_stride, group_stride,
                                            offset)):
        vec //= 2
    nvec = groups * width // vec
    team = 1
    while team < _THREADS and 2 * team < nvec:
        team *= 2
    if -(-nvec // team) * vec > _VALUES:
        raise ValueError(
            f"a segment of {groups} x {width} elements in loads of {vec} "
            f"is over the {_THREADS * _VALUES} values a CTA of the flat "
            f"norm kernel keeps")
    return FlatNormDesc(rows, groups, segs, width, row_stride, group_stride,
                        offset, vec, team)


def flat_norm_cuda(norms):
    """Launch the kernel on the current stream (no sync), one launch for
    up to three norms. norms: ((x, segs, scale, bias, alpha, eps), ...),
    x a [rows, groups, segs * width] view whose last stride is 1, scale
    and bias [groups * width] in x's dtype, alpha a one-element PReLU
    slope or None. Returns the contiguous [rows, groups * segs * width]
    outputs. Inference only: it refuses inputs that need a gradient."""
    if not 1 <= len(norms) <= _MAX_DESCS:
        raise ValueError(f"flat_norm_cuda takes 1 to {_MAX_DESCS} norms")
    dev, dt = norms[0][0].device, norms[0][0].dtype
    if dev.type != "cuda":
        raise ValueError("flat_norm_cuda needs GPU tensors")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError("flat_norm_cuda takes float32 or bfloat16")
    elem = 4 if dt == torch.float32 else 2
    ptrs, dims, eps_all, outs = [], [], [], []
    for x, segs, scale, bias, alpha, eps in norms:
        tensors = [t for t in (x, scale, bias, alpha) if t is not None]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise RuntimeError("flat_norm_cuda is inference only and would "
                               "drop the gradient")
        if any(t.device != dev or t.dtype != dt for t in tensors):
            raise ValueError("flat_norm_cuda: every tensor on one GPU in "
                             "one dtype")
        if x.dim() != 3 or x.stride(2) != 1 or x.shape[2] % segs:
            raise ValueError(f"flat_norm_cuda: x must be [rows, groups, "
                             f"segs * width] with unit last stride, got "
                             f"{tuple(x.shape)} strides {x.stride()}")
        rows, groups, cols = x.shape
        width = cols // segs
        if scale.numel() != groups * width or bias.numel() != groups * width \
                or not (scale.is_contiguous() and bias.is_contiguous()) \
                or (alpha is not None and alpha.numel() != 1):
            raise ValueError("flat_norm_cuda: scale and bias must be "
                             "contiguous [groups * width], alpha one value")
        base = x.data_ptr() - x.storage_offset() * elem
        if any(p % 16 for p in (base, scale.data_ptr(), bias.data_ptr())):
            raise ValueError("flat_norm_cuda: x's storage, scale and bias "
                             "must start 16-byte aligned")
        d = flat_norm_desc(rows, groups, segs, width, x.stride(0),
                           x.stride(1), x.storage_offset(), elem)
        out = torch.empty((rows, groups * cols), dtype=dt, device=dev)
        ptrs += [x.data_ptr(), out.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), None if alpha is None else alpha.data_ptr()]
        dims += [d.rows, d.groups, d.segs, d.width, d.row_stride,
                 d.group_stride, d.vec, d.team]
        eps_all.append(float(eps))
        outs.append(out)
    n = len(norms)
    lib = _build.load_library()
    fn = lib.flat_norm_f32 if dt == torch.float32 else lib.flat_norm_bf16
    rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(dims))(*dims),
            (ctypes.c_float * n)(*eps_all), n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "flat_norm")
    flat_norm_cuda.launches += 1
    return outs


flat_norm_cuda.launches = 0
