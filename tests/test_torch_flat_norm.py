"""The host side of the flat LayerNorm kernel (`csrc/flat_norm.cu`),
checked without a card: the descriptor each caller's view maps to, a
plain emulation of the kernel's addressing driven by that descriptor
against the plain versions, the dispatch of CPU tensors, and the
constants the descriptor shares with the kernel source. The card tests
(tests/test_torch_cuda.py) hold the kernel itself to the plain
versions."""

import re

import pytest
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops import norms
from lookoncetohear_tpu_torch.ops.norms import (FlatNormDesc,
                                                flat_head_layer_norm,
                                                flat_layer_norm,
                                                flat_layer_norm_reference,
                                                flat_norm_desc,
                                                flat_qkv_layer_norm,
                                                head_segment_matrix)

# the flagship's fused Q/K/V projection: F=97, 4 heads, e=6, v dim 16,
# so C = 2 * 6 * 4 + 16 * 4 = 112 columns a frequency
F, NH, E, VD = 97, 4, 6, 16
C = 2 * E * NH + VD * NH


@pytest.mark.parametrize("elem,want", [
    (2, [FlatNormDesc(64, F, NH, E, F * C, C, 0, 2, 256),
         FlatNormDesc(64, F, NH, E, F * C, C, E * NH, 2, 256),
         FlatNormDesc(64, F, NH, VD, F * C, C, 2 * E * NH, 8, 128)]),
    (4, [FlatNormDesc(64, F, NH, E, F * C, C, 0, 2, 256),
         FlatNormDesc(64, F, NH, E, F * C, C, E * NH, 2, 256),
         FlatNormDesc(64, F, NH, VD, F * C, C, 2 * E * NH, 4, 256)])],
    ids=["bf16", "f32"])
def test_qkv_descriptors_of_the_fused_projection(elem, want):
    """Q, K and V read where they lie in y [64, 97, 112]: 2-element loads
    for heads of 6 (12 or 24 bytes), 16-byte loads for the v dim of 16,
    at most two loads a thread."""
    got = [flat_norm_desc(64, F, NH, dim, F * C, C, off, elem)
           for dim, off in ((E, 0), (E, E * NH), (VD, 2 * E * NH))]
    assert got == want


@pytest.mark.parametrize("rows,d,elem,vec,team", [
    (64 * 97, 64, 2, 8, 4),      # flagship intra / inter, bf16
    (64, 97 * 64, 2, 8, 256),    # flagship attention output, bf16
    (64 * 141, 64, 4, 4, 8),     # net_default intra / inter, float32
    (64, 97 * 64, 4, 4, 256),    # the flagship's in float32
    (3, 10, 2, 2, 4),            # a width 16 bytes do not divide
])
def test_row_descriptors(rows, d, elem, vec, team):
    got = flat_norm_desc(rows, 1, 1, d, d, d, 0, elem)
    assert got == FlatNormDesc(rows, 1, 1, d, d, d, 0, vec, team)
    nvec = d // vec
    assert -(-nvec // team) <= 2 or team == norms._THREADS
    assert -(-nvec // team) * vec <= norms._VALUES


def test_descriptor_refuses_a_segment_over_a_ctas_registers():
    flat_norm_desc(1, 1, 1, norms._THREADS * norms._VALUES, 8, 8, 0, 2)
    with pytest.raises(ValueError, match="values a CTA"):
        flat_norm_desc(1, 1, 1, norms._THREADS * norms._VALUES + 8, 8, 8,
                       0, 2)
    # odd strides cut the loads to one element and the room with them
    with pytest.raises(ValueError, match="values a CTA"):
        flat_norm_desc(1, 1, 1, 8193, 8193, 8193, 0, 2)


def emulate(storage, d: FlatNormDesc, scale, bias, alpha, eps):
    """The kernel's arithmetic at the kernel's addresses: thread t of the
    team of segment (r, s) takes load j = i * team + t for i below
    kValues / vec, the vec elements at offset + r * row_stride + g *
    group_stride + s * width + c, g = j // (width / vec), and writes
    them to r * G * S * W + g * S * W + s * W + c with the affine of j *
    vec. Returns the output and how often each element was written."""
    W, G, S, V = d.width, d.groups, d.segs, d.vec
    wv = W // V
    nvec = G * wv
    loads = [i * d.team + t for i in range(norms._VALUES // V)
             for t in range(d.team) if i * d.team + t < nvec]
    assert sorted(loads) == list(range(nvec)), "a load missed or repeated"
    j = torch.tensor(loads)
    g = j // wv
    c = (j - g * wv) * V
    k = torch.arange(V)
    r = torch.arange(d.rows)[:, None, None, None]
    s = torch.arange(S)[None, :, None, None]
    src = (d.offset + r * d.row_stride + s * W
           + (g * d.group_stride + c)[None, None, :, None] + k)
    dst = (r * G * S * W + s * W + (g * S * W + c)[None, None, :, None]
           + k)
    aff = (j[:, None] * V + k).reshape(-1)
    v = storage[src].float().reshape(d.rows, S, -1)
    if alpha is not None:
        v = torch.where(v >= 0, v,
                        (alpha.float() * v).to(storage.dtype).float())
    n = float(G * W)
    mu = v.sum(-1, keepdim=True) / n
    m2 = (v * v).sum(-1, keepdim=True) / n
    inv = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + eps)
    y = (v - mu) * inv * scale.float()[aff] + bias.float()[aff]
    out = torch.zeros(d.rows * G * S * W, dtype=storage.dtype)
    out[dst.reshape(-1)] = y.to(storage.dtype).reshape(-1)
    hits = torch.bincount(dst.reshape(-1), minlength=out.numel())
    return out.reshape(d.rows, -1), hits


def _qkv_inputs(b, f, nh, e, vd, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    c = 2 * e * nh + vd * nh
    y = (torch.randn(b, f, c, generator=g) * 0.7 + 0.1).to(dtype)
    parts = []
    for dim in (e, e, vd):
        parts.append((dim, (torch.rand(1, generator=g) * 0.4).to(dtype),
                      (1 + 0.3 * torch.randn(f * dim, generator=g)).to(dtype),
                      (0.2 * torch.randn(f * dim, generator=g)).to(dtype),
                      1e-5))
    return y, parts


@pytest.mark.parametrize("b,f,nh,e,vd", [(2, F, NH, E, VD), (3, 5, 2, 3, 8),
                                         (1, 7, 4, 5, 4)])
def test_emulated_addressing_matches_the_head_norms(b, f, nh, e, vd):
    """Each block of a fused projection, read through its descriptor,
    equals the PReLU then `flat_head_layer_norm` on the block's slice
    with the affine expanded over the heads; every output written
    once."""
    y, parts = _qkv_inputs(b, f, nh, e, vd, torch.float32, b + f)
    c = y.shape[-1]
    want = flat_qkv_layer_norm(y, nh, parts)
    col = 0
    for (dim, alpha, scale, bias, eps), w in zip(parts, want):
        view = y[..., col:col + nh * dim]
        d = flat_norm_desc(b, f, nh, dim, view.stride(0), view.stride(1),
                           view.storage_offset(), 4)
        assert (d.row_stride, d.group_stride, d.offset) == (f * c, c, col)
        got, hits = emulate(y.reshape(-1), d, scale, bias, alpha, eps)
        assert torch.equal(hits, torch.ones_like(hits))
        torch.testing.assert_close(got, w, rtol=0, atol=2e-5)
        # the same block by hand: PReLU, per-head statistics over f*dim
        x = view.reshape(b, f, nh, dim)
        x = torch.where(x >= 0, x, alpha * x)
        mu = x.mean((1, 3), keepdim=True)
        var = (x * x).mean((1, 3), keepdim=True) - mu * mu
        ref = (x - mu) * torch.rsqrt(var + eps)
        ref = ref * scale.reshape(f, 1, dim) + bias.reshape(f, 1, dim)
        torch.testing.assert_close(got, ref.reshape(b, -1), rtol=0,
                                   atol=2e-5)
        col += nh * dim


@pytest.mark.parametrize("rows,d", [(64 * 97, 64), (64, 97 * 64),
                                    (3, 8192), (5, 10)])
def test_emulated_addressing_matches_the_row_norm(rows, d):
    g = torch.Generator().manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g) * 1.3 - 0.4
    sc = 1 + 0.3 * torch.randn(d, generator=g)
    bi = 0.2 * torch.randn(d, generator=g)
    desc = flat_norm_desc(rows, 1, 1, d, d, d, 0, 4)
    got, hits = emulate(x.reshape(-1), desc, sc, bi, None, 1e-5)
    assert torch.equal(hits, torch.ones_like(hits))
    torch.testing.assert_close(got, flat_layer_norm(x, sc, bi, 1e-5),
                               rtol=0, atol=2e-5)


def test_qkv_cpu_path_is_the_previous_fused_form():
    """On the CPU the fused form is the step's previous code: one PReLU
    over the projection with the three slopes, then
    `flat_head_layer_norm` on each slice with the affine expanded over
    the heads, bit for bit, in bf16 too."""
    for dtype in (torch.float32, torch.bfloat16):
        y, parts = _qkv_inputs(3, F, NH, E, VD, dtype, 7)
        got = flat_qkv_layer_norm(y, NH, parts)
        widths = [NH * p[0] for p in parts]
        alpha = torch.cat([p[1].expand(w) for p, w in zip(parts, widths)])
        yp = torch.where(y >= 0, y, alpha * y)
        col = 0
        for (dim, _, sc, bi, eps), out in zip(parts, got):
            seg = torch.from_numpy(head_segment_matrix(F * NH * dim, NH,
                                                       dim))
            sce = sc.reshape(F, 1, dim).expand(F, NH, dim).reshape(-1)
            bie = bi.reshape(F, 1, dim).expand(F, NH, dim).reshape(-1)
            want = flat_head_layer_norm(
                yp[..., col:col + NH * dim].reshape(3, -1), seg,
                float(F * dim), sce, bie, eps)
            assert out.dtype == dtype and torch.equal(out, want)
            col += NH * dim


def test_cpu_tensors_take_the_plain_path():
    """The CPU forms and a streaming int8 step on the CPU launch nothing:
    the kernel's counter stays where it was, and the row norm is its
    plain version bit for bit."""
    from lookoncetohear_tpu_torch.models.net import Net
    before = norms.flat_norm_cuda.launches
    x = torch.randn(12, 64)
    sc, bi = torch.rand(64), torch.rand(64)
    assert torch.equal(flat_layer_norm(x, sc, bi, 1e-5),
                       flat_layer_norm_reference(x, sc, bi, 1e-5))
    y, parts = _qkv_inputs(2, 5, 2, 3, 8, torch.float32, 1)
    flat_qkv_layer_norm(y, 2, parts)
    torch.manual_seed(0)
    net = Net(embed_dim=32, stft_chunk_size=48, stft_pad_size=16, num_ch=2,
              D=16, L=2, B=2, H=64, local_atten_len=5, use_attn=True,
              chunk_causal=True, device="cpu")
    state = net.init_state(2, kv_dtype=torch.int8)
    out, _ = net.step(torch.randn(2, 2, 64), torch.randn(2, 32), state)
    assert torch.isfinite(out).all()
    assert norms.flat_norm_cuda.launches == before == 0


def test_the_kernel_refuses_cpu_tensors():
    x = torch.randn(4, 1, 8)
    with pytest.raises(ValueError, match="GPU"):
        norms.flat_norm_cuda([(x, 1, torch.ones(8), torch.zeros(8), None,
                               1e-5)])
    with pytest.raises(ValueError, match="1 to 3"):
        norms.flat_norm_cuda([])


def test_descriptor_mirrors_the_kernel_source():
    """The descriptor's constants are the kernel's, and the C entries
    take the pointers and ints in the order the wrapper packs them."""
    text = (_build.CSRC / "flat_norm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))
    assert const("kThreads") == norms._THREADS
    assert const("kValues") == norms._VALUES
    assert const("kMaxDescs") == norms._MAX_DESCS
    assert const("kMaxVecBytes") == norms._MAX_VEC_BYTES
    assert const("kPtrs") == 5 and const("kDims") == 8
    fields = re.search(r"d\.x = p\[0\];(.*?)d\.eps = eps\[i\];", text,
                       re.S).group(1)
    order = re.findall(r"d\.(\w+) = m\[(\d)\];", fields)
    assert [name for name, _ in order] == [
        "rows", "groups", "segs", "width", "row_stride", "group_stride",
        "vec", "team"]
    assert [int(i) for _, i in order] == list(range(8))
    assert "__launch_bounds__(kThreads)" in text
    for name in ("flat_norm_f32", "flat_norm_bf16"):
        assert _build._SIGNATURES[name][3] is _build._I

