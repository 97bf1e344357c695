"""The host side of the ring attention kernel (csrc/attn_step.cu),
checked without a card: `attn_step_plan` mirrors how the kernel cuts a
launch (K tiles, then V tiles, through a ring of shared-memory buffers;
V column blocks) and `k_tile_copies` how it stages a row's K span
(16-byte bulk copies of the span's aligned interior, the ragged head and
tail element by element). Every byte of a K tile's slots must reach its
buffer exactly once, no copy may read outside the row's span, and a
numpy emulation of the kernel's arithmetic over those buffers must
agree with the plain version. The card tests (tests/test_torch_cuda.py)
hold the kernel itself to the plain version."""

import re

import numpy as np
import pytest
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops import attn_step as A

SERVING = dict(w1=49, dk=97 * 6, dv=97 * 16)
# an H100 SM holds 228 KB of shared memory; each block also takes 1 KB
# for the system and the kernel's static variables (< 1 KB)
SM_SMEM = 233472
PER_BLOCK_EXTRA = 1024 + 1024


@pytest.mark.parametrize("elem_bytes,dk,align", [
    (eb, dk, al) for eb in (4, 2, 1) for dk in (7, 525, 582)
    for al in (1, 2, 4, 16) if al % eb == 0])
def test_k_staging_covers_every_byte_once(elem_bytes, dk, align):
    """Rows whose K span starts 1-, 2-, 4- or 16-byte aligned (as far
    as the element size allows): each chunk's bytes reach its buffer
    once, by the bulk copy or by one ragged element."""
    for w1 in (1, 3, 49):
        plan = A.attn_step_plan(w1, dk, 1552, elem_bytes, elem_bytes == 1)
        # 16-byte aligned storage, then a start of exactly `align`
        kb = 4096 + (align if align < 16 else 0)
        chunks = A.k_tile_copies(kb, w1, dk, elem_bytes, plan.kslots)
        assert len(chunks) == plan.ktiles
        ke = kb + w1 * dk * elem_bytes
        assert chunks[0].start == kb and chunks[-1].end == ke
        assert all(a.end == b.start for a, b in zip(chunks, chunks[1:]))
        edges = [e for c in chunks for e in c.edges]
        assert len(edges) == len(set(edges)) <= 32
        for c in chunks:
            if c.hi > c.lo:
                assert c.lo % 16 == 0 and c.hi % 16 == 0
                assert kb <= c.lo and c.hi <= ke    # inside the span
                assert 0 <= c.lo - c.base and c.hi - c.base <= plan.cap
            bulk = set(range(c.lo, c.hi))
            got = [x for x in range(c.start, c.end) if x in bulk]
            for e in c.edges:
                assert e % elem_bytes == 0 and not bulk & set(
                    range(e, e + elem_bytes))
                got += range(e, e + elem_bytes)
            assert sorted(got) == list(range(c.start, c.end)), (w1, c)
            assert c.end - c.base <= plan.cap


@pytest.mark.parametrize("elem_bytes,scaled,ktiles,vtiles",
                         [(4, False, 5, 17), (2, False, 3, 7),
                          (1, True, 2, 4)])
def test_plan_at_the_serving_shape(elem_bytes, scaled, ktiles, vtiles):
    """The float32, bf16 and int8 rings of the serving shape: tiles of
    about 24 KB, three buffers, two blocks an SM, so the 256 rows run on
    the H100's 132 SMs in one wave."""
    plan = A.attn_step_plan(**SERVING, elem_bytes=elem_bytes, scaled=scaled)
    assert (plan.ktiles, plan.vtiles, plan.stages) == (ktiles, vtiles, 3)
    assert plan.col_blocks == 1 and plan.cols == SERVING["dv"]
    for slots, tiles in ((plan.kslots, plan.ktiles),
                         (plan.vslots, plan.vtiles)):
        assert (tiles - 1) * slots < 49 <= tiles * slots
    assert plan.cap <= A._TILE_BYTES + 48
    assert SM_SMEM // (plan.smem + PER_BLOCK_EXTRA) >= 2
    assert 256 <= 132 * 2


def test_plan_limits():
    """Wide V rows take more column blocks; any slot count fits; only a
    K row too wide for shared memory is refused."""
    p = A.attn_step_plan(49, 582, 4100, 4, False)
    assert p.col_blocks == 3 and p.cols == 2048
    for w1 in (0, 1, 2, 500):
        p = A.attn_step_plan(w1, 7, 16, 2, False)
        assert p.smem <= A._MAX_SMEM
        assert p.ktiles * p.kslots >= w1 and p.vtiles * p.vslots >= w1
    assert A.attn_step_plan(49, 20000, 1552, 4, False).smem <= A._MAX_SMEM
    assert A.attn_step_plan(49, 40000, 1552, 4, False).smem > A._MAX_SMEM


def _emulate(q, kt, vt, kbuf, vbuf, ksc, vsc, elem_bytes):
    """The kernel's arithmetic in numpy, row by row: the K bytes of each
    tile staged as `k_tile_copies` says, scores from the staged bytes,
    one softmax over them and the current frame, values tile by tile."""
    b, w1, dk = kbuf.shape
    dv = vbuf.shape[-1]
    plan = A.attn_step_plan(w1, dk, dv, elem_bytes, ksc is not None)
    flat = kbuf.reshape(-1).view(np.uint8)
    inv = np.float32(1.0 / np.sqrt(dk))
    out = np.empty((b, dv), np.float32)
    for r in range(b):
        kb = r * w1 * dk * elem_bytes        # the storage is 16-aligned
        s = np.empty(w1 + 1, np.float32)
        for t, tl in enumerate(A.k_tile_copies(kb, w1, dk, elem_bytes,
                                               plan.kslots)):
            buf = np.zeros(plan.cap, np.uint8)
            if tl.hi > tl.lo:
                buf[tl.lo - tl.base:tl.hi - tl.base] = flat[tl.lo:tl.hi]
            for e in tl.edges:
                buf[e - tl.base:e - tl.base + elem_bytes] = \
                    flat[e:e + elem_bytes]
            j0 = t * plan.kslots
            n = (tl.end - tl.start) // (dk * elem_bytes)
            off = tl.start - tl.base
            rows = buf[off:off + n * dk * elem_bytes].view(
                kbuf.dtype).reshape(n, dk).astype(np.float32)
            s[j0:j0 + n] = rows @ q[r]
            if ksc is not None:
                s[j0:j0 + n] *= ksc[r, j0:j0 + n]
            s[j0:j0 + n] *= inv
        s[w1] = (q[r] @ kt[r]) * inv
        e = np.exp(s - s.max())
        w = e[:w1] if vsc is None else e[:w1] * vsc[r]
        acc = np.zeros(dv, np.float32)
        for j0 in range(0, w1, plan.vslots):
            acc += w[j0:j0 + plan.vslots] @ \
                vbuf[r, j0:j0 + plan.vslots].astype(np.float32)
        out[r] = (acc + e[w1] * vt[r]) / e.sum()
    return out


@pytest.mark.parametrize("ring", ["float32", "int8"])
@pytest.mark.parametrize("dk,w1", [(7, 3), (525, 49), (582, 20)])
def test_emulated_kernel_matches_plain(ring, dk, w1):
    """The K staging and the tiled arithmetic reproduce the plain
    version (float32, atol 1e-5) on odd and even Dk."""
    rng = np.random.default_rng(dk + w1)
    b, dv = 3, 32
    q, kt = (rng.standard_normal((b, dk)).astype(np.float32)
             for _ in range(2))
    vt = rng.standard_normal((b, dv)).astype(np.float32)
    if ring == "int8":
        kbuf = rng.integers(-127, 128, (b, w1, dk)).astype(np.int8)
        vbuf = rng.integers(-127, 128, (b, w1, dv)).astype(np.int8)
        ksc, vsc = (rng.uniform(1e-3, 2e-2, (b, w1)).astype(np.float32)
                    for _ in range(2))
    else:
        kbuf, vbuf = (rng.standard_normal((b, w1, d)).astype(np.float32)
                      for d in (dk, dv))
        ksc = vsc = None
    got = _emulate(q, kt, vt, kbuf, vbuf, ksc, vsc, kbuf.itemsize)
    t = [torch.from_numpy(x) for x in (q, kt, vt, kbuf, vbuf)]
    sc = {} if ksc is None else dict(k_scale=torch.from_numpy(ksc),
                                     v_scale=torch.from_numpy(vsc))
    want = A.attention_step_reference(*t, **sc).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plan_mirrors_the_kernel_source():
    """The mirror's constants are the kernel's."""
    text = (_build.CSRC / "attn_step.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([\d *]+);", text)
        return eval(m.group(1))    # noqa: S307 - digits and '*' only
    assert const("kThreads") == A._THREADS
    assert const("kGranules") == A._GRANULES
    assert const("kTileBytes") == A._TILE_BYTES
    assert const("kMaxStages") == A._MAX_STAGES
    assert const("kBarBytes") == A._BAR_BYTES >= 8 * A._MAX_STAGES
    assert const("kMaxSmem") == A._MAX_SMEM
    assert "__launch_bounds__(kThreads, 2)" in text
