"""The launch plans of the redesigned histogram kernels, K1
(``ops/leafhist.py`` :func:`plan`) and K3 (``ops/children_hist.py``
:func:`plan_fused`): pure functions, checked here over their whole input
space with hypothesis.  The kernels that run them are held against
their plain versions on the card by ``chip_smoke.py`` and the
``cuda``-marked tests.

K1: every row of the window falls in exactly one block of each feature
group; a block's shared memory fits; a cluster is no larger than 16 (the
non-portable limit, 8 portable otherwise) and the chunks are whole
clusters; the small path is one cluster a group; the large path launches
no clusters and stays within one wave of :data:`BLOCKS_PER_SM` blocks a
SM; the path follows :data:`SMALL_WINDOW_MAX_ROWS`.  K3: every row falls in exactly one block
of each group, every group has ``per_group`` distinct partial slots, the
cooperative grid never exceeds the resident blocks, and shared memory
fits.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import children_hist as ch
from lightgbm_tpu_torch.ops import leafhist as lh

pytestmark = pytest.mark.torch

SMEM_LIMIT = 232448
# widest bins one feature's histogram still fits a block at: K1 [9, B]
# int32, K3 [2, B, 3] f32
K1_MAX_BIN = SMEM_LIMIT // (9 * 4)
K3_MAX_BIN = (SMEM_LIMIT - ch.FUSED_QUEUE_BYTES) // (2 * 3 * 8)


def _tiles(ranges, lo, hi):
    """The ranges, sorted, cover [lo, hi) once: no gap, no overlap."""
    ranges = sorted(r for r in ranges if r[1] > r[0])
    at = lo
    for a, b in ranges:
        assert a == at, (a, at)
        at = b
    assert at == hi


@settings(max_examples=300, deadline=None, database=None)
@given(count=st.integers(0, lh.MAX_WINDOW_ROWS - 1),
       F=st.integers(1, 64), B=st.integers(2, K1_MAX_BIN),
       bin_bytes=st.sampled_from([1, 2]), sms=st.integers(1, 160),
       path=st.sampled_from([None, "small", "large"]))
def test_k1_plan(count, F, B, bin_bytes, sms, path):
    if bin_bytes == 1:
        B = min(B, 256)
    p = lh.plan(count, F, B, sms, path)
    assert p.path == (path or ("small" if count <= lh.SMALL_WINDOW_MAX_ROWS
                               else "large"))
    assert p.smem == p.fg * 9 * B * 4 <= SMEM_LIMIT
    assert p.groups == -(-F // p.fg) and (p.groups - 1) * p.fg < F
    assert 1 <= p.cluster <= 16
    assert p.cluster <= 8 or lh.CLUSTER_SMALL > 8 and p.path == "small"
    assert p.chunks % p.cluster == 0
    if p.path == "small":
        assert p.chunks == p.cluster and p.fg <= 2
    else:
        assert p.cluster == 1
        assert p.chunks * p.groups <= max(lh.BLOCKS_PER_SM * sms, p.groups)
    # the kernel's rows of chunk c: [c * rows_per_block, ...) up to count
    _tiles([lh.block_rows(p, count, c) for c in range(p.chunks)], 0, count)


@settings(max_examples=50, deadline=None, database=None)
@given(count=st.integers(0, 1 << 20), F=st.integers(1, 40))
def test_k1_default_path_switches_at_the_threshold(count, F):
    p = lh.plan(count, F, 255, 132)
    assert (p.path == "small") == (count <= lh.SMALL_WINDOW_MAX_ROWS)
    edge = lh.SMALL_WINDOW_MAX_ROWS
    assert lh.plan(edge, F, 255, 132).path == "small"
    assert lh.plan(edge + 1, F, 255, 132).path == "large"


def test_k1_plan_refuses_what_cannot_fit():
    with pytest.raises(LightGBMError, match="shared memory"):
        lh.plan(100, 4, K1_MAX_BIN + 1, 132)
    with pytest.raises(LightGBMError, match="path"):
        lh.plan(100, 4, 255, 132, "medium")


@settings(max_examples=300, deadline=None, database=None)
@given(N=st.integers(0, 1 << 22), F=st.integers(1, 300),
       B=st.integers(2, K3_MAX_BIN), bin_bytes=st.sampled_from([1, 2]),
       sms=st.integers(1, 160), blocks_per_sm=st.integers(1, 8))
def test_k3_plan(N, F, B, bin_bytes, sms, blocks_per_sm):
    if bin_bytes == 1:
        B = min(B, 256)
    p = ch.plan_fused(F, B, sms, blocks_per_sm)
    assert p.smem == p.fg * 2 * B * 3 * 8 + p.queue * 16 + 16 <= SMEM_LIMIT
    assert p.tile == ch.FUSED_THREADS * 4 and p.queue >= 1
    assert p.groups == -(-F // p.fg) and (p.groups - 1) * p.fg < F
    # one block a SM at most, never more than can be resident
    assert 1 <= p.grid <= min(sms, sms * blocks_per_sm)
    assert p.grid % p.per_group == 0
    slots = {}
    rows = {}
    for b in range(p.grid):
        groups, ranges = ch.fused_block_rows(p, N, b)
        assert groups, f"block {b} takes no feature group"
        for g in groups:
            slots.setdefault(g, []).append(b % p.per_group)
            rows.setdefault(g, []).extend(ranges)
    assert sorted(slots) == list(range(p.groups))
    for g in range(p.groups):
        # per_group distinct partial slots; together they scan every row
        assert sorted(slots[g]) == list(range(p.per_group))
        _tiles(rows[g], 0, N)


def test_k3_plan_at_the_training_shapes():
    # F = 28 at 255 bins: two groups of 14 features, each block's f64
    # histograms 171 KB, one block a SM of an H100 beside the 16 KB row
    # queue; uint16 at 1000 bins: 8 groups of 4 features
    p = ch.plan_fused(28, 255, 132, 1)
    assert (p.fg, p.groups, p.per_group, p.grid) == (14, 2, 66, 132)
    assert p.smem == 171360 + 16384 + 16
    p = ch.plan_fused(30, 1000, 132, 1)
    assert (p.fg, p.groups, p.per_group, p.grid) == (4, 8, 16, 128)
    with pytest.raises(LightGBMError, match="resident"):
        ch.plan_fused(28, 255, 132, 0)
    with pytest.raises(LightGBMError, match="shared memory"):
        ch.plan_fused(4, K3_MAX_BIN + 1, 132, 1)


def test_wrappers_take_plan_options_on_cpu_and_run_the_plain_version():
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(rng.randint(0, 16, (300, 5)).astype(np.uint8))
    dig = torch.from_numpy(rng.randint(-128, 128, (300, 9)).astype(np.int8))
    want = lh.digit_histogram_plain(bins, dig, 16, 7, 200)
    lh.reset_launch_counts()
    for path in (None, "small", "large"):
        got = lh.digit_histogram(bins, dig, 16, 7, 200, path=path)
        assert torch.equal(got, want)
    assert lh.launch_counts() == {"digit_histogram": 0}
