"""The launch plan of the tree-parallel forest walk K4
(``ops/forest_walk.py`` :func:`plan_walk`): a pure function, checked here
over its input space with hypothesis.  The kernel that runs it is held
against its plain version on the card by ``chip_smoke.py`` and the
``cuda``-marked tests.

Every (tree, row) falls in exactly one (block, thread, slot) of the walk
(:func:`walk_items` states the kernel's mapping); a block's shared
memory fits; the grid fills the SMs wherever B * K * T allows it; and the
plan refuses exactly the forests the first port's walk refused: one
tree's tables beside a 32-row tile over 232,448 bytes.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import forest_walk as fw

pytestmark = pytest.mark.torch

SMEM_LIMIT = 232448


def first_port_refuses(M, L, leaf_bytes, Kf, linear, F) -> bool:
    """The first port's ``block_size``: its smallest block, 32 rows, held
    one tree's nodes (16 bytes each), the leaf table padded to 16 bytes,
    the [F][32] u16 bin tile and, for a linear forest, the tree's affine
    tables (8 bytes a slot) and the [F][32] f32 covariate tile."""
    b = 16 * M + -(-L * leaf_bytes // 16) * 16 + 2 * F * 32
    if linear:
        b += 8 * L * Kf + 4 * F * 32
    return b > SMEM_LIMIT


def _plan(B, K, T, L, F, Kf, leaf_bytes, linear, raw, sms):
    return fw.plan_walk(B, K, T, L - 1, L, F, Kf if linear else 0,
                        leaf_bytes, linear, raw, sms)


@settings(max_examples=120, deadline=None, database=None)
@given(B=st.integers(1, 1500), K=st.integers(1, 3), T=st.integers(1, 60),
       L=st.integers(2, 300), F=st.integers(1, 64), Kf=st.integers(1, 6),
       leaf_bytes=st.sampled_from([4, 2]), linear=st.booleans(),
       raw=st.booleans(), sms=st.integers(1, 160))
def test_every_tree_and_row_walked_once(B, K, T, L, F, Kf, leaf_bytes,
                                        linear, raw, sms):
    p = _plan(B, K, T, L, F, Kf, leaf_bytes, linear, raw, sms)
    KT = K * T
    trees, rows, blocks, threads = fw.walk_items(p, KT, B)
    counts = np.bincount(trees * B + rows, minlength=KT * B)
    assert counts.shape == (KT * B,) and (counts == 1).all()
    assert (threads < p.threads).all()
    # each block: one chunk of trees, one tile of rows
    for b in np.unique(blocks)[:50]:
        t, r = trees[blocks == b], rows[blocks == b]
        assert t.max() - t.min() < p.chunk and r.max() - r.min() < p.tile
    assert p.bin_scratch == (2 * F * B if raw else 0)


@settings(max_examples=300, deadline=None, database=None)
@given(B=st.integers(1, 1 << 20), K=st.integers(1, 10),
       T=st.integers(1, 3000), L=st.integers(2, 70000),
       F=st.integers(1, 5000), Kf=st.integers(1, 40),
       leaf_bytes=st.sampled_from([4, 2]), linear=st.booleans(),
       raw=st.booleans(), sms=st.integers(1, 160))
def test_shared_memory_grid_and_refusals(B, K, T, L, F, Kf, leaf_bytes,
                                         linear, raw, sms):
    M = L - 1
    args = (B, K, T, L, F, Kf, leaf_bytes, linear, raw, sms)
    if first_port_refuses(M, L, leaf_bytes, Kf, linear, F):
        with pytest.raises(LightGBMError, match="more shared memory"):
            _plan(*args)
        return
    p = _plan(*args)
    assert p.smem == fw.walk_smem(p.chunk, M, L, leaf_bytes,
                                  Kf if linear else 0, linear, F, p.tile)
    assert p.smem <= SMEM_LIMIT
    assert p.rows_per_thread == fw.WALK_ROWS_PER_THREAD
    assert 32 <= p.threads <= fw.WALK_THREADS and p.threads % 32 == 0
    assert 1 <= p.tile <= min(B, fw.WALK_TILES[0])
    assert p.chunks == -(-K * T // p.chunk)
    assert p.row_tiles == -(-p.wave // p.tile) <= fw.MAX_ROW_TILES
    assert p.wave <= B and (p.wave == B or 4 * K * T * p.wave
                            <= max(fw.WALK_SCRATCH_BYTES,
                                   4 * K * T * p.tile))
    if B * K * T >= sms:
        assert p.grid >= sms
    assert p.fold_warps == (K * p.wave <= fw.WALK_WARP_FOLD_MAX)


def test_plan_at_the_serving_shapes():
    # the Higgs forest (500 trees, 255 leaves, 28 features) on 132 SMs:
    # at B = 1 small chunks over many blocks; at B >= 4096 as many trees
    # a block as shared memory holds, spread to whole waves
    one = _plan(1, 1, 500, 255, 28, 0, 4, False, False, 132)
    assert (one.tile, one.chunk, one.row_tiles) == (1, 3, 1)
    assert one.grid >= 132
    big = _plan(4096, 1, 500, 255, 28, 0, 4, False, False, 132)
    assert big.tile == 512 and big.row_tiles == 8
    assert 132 <= big.grid <= 2 * 132 and big.chunk >= 16
    huge = _plan(1 << 20, 1, 500, 255, 28, 0, 4, False, True, 132)
    assert huge.wave < 1 << 20
    assert 4 * 500 * huge.wave <= fw.WALK_SCRATCH_BYTES
    assert huge.bin_scratch == 2 * 28 * (1 << 20)
    with pytest.raises(LightGBMError, match="nothing to walk"):
        _plan(0, 1, 500, 255, 28, 0, 4, False, False, 132)


@settings(max_examples=60, deadline=None, database=None)
@given(B=st.integers(1, 3000), K=st.integers(1, 3), T=st.integers(1, 40),
       L=st.integers(2, 64), rows=st.integers(1, 700),
       linear=st.booleans(), sms=st.integers(1, 160))
def test_waves_of_rows_cover_every_row_once(B, K, T, L, rows, linear, sms):
    # a scratch cap of `rows` rows a wave: B rows take several waves, as a
    # forest of many trees or classes takes them at its own size
    saved = fw.WALK_SCRATCH_BYTES
    fw.WALK_SCRATCH_BYTES = 4 * K * T * rows
    fw.plan_walk.cache_clear()
    try:
        p = _plan(B, K, T, L, 28, 5, 4, linear, False, sms)
    finally:
        fw.WALK_SCRATCH_BYTES = saved
        fw.plan_walk.cache_clear()
    assert p.wave == min(B, max(p.tile, rows // p.tile * p.tile))
    assert 4 * K * T * p.wave <= 4 * K * T * max(rows, p.tile)
    trees, rowsw, _, threads = fw.walk_items(p, K * T, B)
    counts = np.bincount(trees * B + rowsw, minlength=K * T * B)
    assert (counts == 1).all() and (threads < p.threads).all()
