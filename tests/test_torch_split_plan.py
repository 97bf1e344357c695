"""The host side of the int8 ring step kernel's split, checked without a
card: `ring_split_plan` gives the S CTAs of a row their slot ranges and
shared memory. CTA r reads its range less `pos` (the kernel's
`slot_of`), so every live slot other than `pos` must be read by exactly
one CTA (slot `pos` by none: it is written in the same launch), and the
CTAs must fit in shared memory at the serving shape. The card tests
(tests/test_torch_cuda.py) hold the kernel itself to this."""

import re

import pytest

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops import ring_step
from lookoncetohear_tpu_torch.ops.ring_step import ring_split_plan

# the flagship's int8 ring: F=97, 4 heads, e=6, v dim 16
SERVING = dict(dk=97 * 4 * 6, dv=97 * 4 * 16, n_head=4)
# an H100 SM holds 228 KB of shared memory; each CTA also takes 1 KB
# for the system and the kernel's static arrays (< 1 KB)
SM_SMEM = 233472
PER_CTA_EXTRA = 1024 + 1024


@pytest.mark.parametrize("wp", [8, 56])
def test_every_live_slot_is_read_exactly_once(wp):
    for w in range(1, wp + 1):
        plan = ring_split_plan(w, **SERVING, elem_bytes=2)
        assert 1 <= plan.split <= 8
        assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == w
        assert all(a[1] == b[0] for a, b in zip(plan.ranges,
                                                plan.ranges[1:]))
        assert plan.max_slots == max(hi - lo for lo, hi in plan.ranges)
        for pos in range(w):
            seen = [s for lo, hi in plan.ranges for s in range(lo, hi)
                    if s != pos]
            assert sorted(seen) == [s for s in range(w) if s != pos], \
                (w, pos)
            assert len(seen) == len(set(seen))


@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_shared_memory_fits_at_the_serving_shape(elem_bytes):
    """Every w up to the 56-slot ring fits one CTA; at the serving w=50
    the CTAs of 64 rows fit the H100's 132 SMs in one wave."""
    for w in range(1, 57):
        plan = ring_split_plan(w, **SERVING, elem_bytes=elem_bytes)
        assert plan.smem_bytes <= ring_step._MAX_DYNAMIC_SMEM, w
    plan = ring_split_plan(50, **SERVING, elem_bytes=elem_bytes)
    assert plan.max_slots == -(-50 // plan.split)
    per_sm = SM_SMEM // (plan.smem_bytes + PER_CTA_EXTRA)
    assert 64 * plan.split <= 132 * per_sm


def test_plan_mirrors_the_kernel_source():
    """The plan's constants are the kernel's: the warps of a CTA, and
    the split the kernel is compiled with (its cluster's size)."""
    text = (_build.CSRC / "ring_int8_step.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text)
                  .group(1))
    split = int(re.search(r"#define LOOKONCE_RING_SPLIT (\d+)", text)
                .group(1))
    assert threads == 32 * ring_step._KERNEL_WARPS
    assert split == ring_step.RING_SPLIT
    assert "__cluster_dims__(kSplit, 1, 1)" in text
    assert "ring_advance_pos" not in text
