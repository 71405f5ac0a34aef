"""The launch plans of the two probe kernels, checked on the CPU.

P2 (``ops/window_hist.py``): :func:`plan_window` is a pure function of
the card and N, never of the window, checked over its input space with
hypothesis: it refuses what cannot fit, stays in one wave, and the
kernel's device-side split, mirrored here by :func:`block_rows`, covers
every row of the clamped window exactly once and no row outside it, for
any (off, count): negative, past N, empty or all of N.  A Python mirror of the kernel's
decomposition (one bin word a group, per-chunk partials summed in chunk
order) equals the plain version.

P1 (``ops/roll_chain.py``): the kernel carries each column's key and
source column through the 28 stages and gathers the 12 words once at the
end.  That formulation, written here in torch, is bit-equal to
``roll_chain_plain`` on random inputs and on adversarial keys (all
equal, only INT_MIN and INT_MAX, already sorted either way).

The kernels themselves are held against their plain versions on the
card by ``chip_smoke.py`` and the ``cuda``-marked tests.
"""

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import leafhist as lh
from lightgbm_tpu_torch.ops import roll_chain as rc
from lightgbm_tpu_torch.ops import window_hist as wh
from lightgbm_tpu_torch.ops.ordered_grow import pack_u8_words

pytestmark = pytest.mark.torch

SMEM_DEFAULT = 48 * 1024      # above it a block needs cudaFuncSetAttribute


# ---------------------------------------------------------------------------
# P2: plan_window and the device-side split


@settings(max_examples=150, deadline=None, database=None)
@given(n=st.integers(1, 1 << 23), F=st.integers(1, 64),
       B=st.integers(1, 256), sms=st.integers(16, 160),
       bps=st.integers(1, 8))
def test_plan_is_one_wave_of_word_groups(n, F, B, sms, bps):
    p = wh.plan_window(n, F, B, sms, bps)
    assert p.groups == -(-F // wh.WORD_FEATURES) <= wh.MAX_BIN_WORDS
    assert p.smem == wh.WORD_FEATURES * 9 * B * 4 <= SMEM_DEFAULT
    assert p.chunks >= 1 and 32 <= p.threads <= 1024
    assert p.threads % 32 == 0
    # a cooperative launch: every block resident at once
    assert p.groups * p.chunks <= sms * min(bps, wh.BLOCKS_PER_SM)
    assert p.chunks <= -(-n // wh.THREADS)
    assert p.partials == p.groups * p.chunks * p.smem // 4
    # the wave is full unless N is too short to fill it
    if n >= wh.THREADS * sms * wh.BLOCKS_PER_SM:
        assert (p.chunks + 1) * p.groups > sms * min(bps, wh.BLOCKS_PER_SM)


def test_plan_refuses_what_cannot_fit():
    with pytest.raises(LightGBMError, match="features"):
        wh.plan_window(1000, 0, 256, 132, 2)
    with pytest.raises(LightGBMError, match="features"):
        wh.plan_window(1000, 65, 256, 132, 2)           # 17 words
    with pytest.raises(LightGBMError, match="bins"):
        wh.plan_window(1000, 28, 257, 132, 2)
    with pytest.raises(LightGBMError, match="resident"):
        wh.plan_window(1000, 28, 256, 3, 2)             # 7 groups, 6 slots
    with pytest.raises(LightGBMError, match="resident"):
        wh.plan_window(1000, 28, 256, 132, 0)
    # 7 groups on 7 slots: one chunk each
    assert wh.plan_window(1000, 28, 256, 7, 1).chunks == 1


def test_plan_sees_no_window():
    # the probe's inputs on an H100 (132 SMs): one plan for every window
    p = wh.plan_window(1 << 20, 28, 256, 132, 2)
    assert (p.groups, p.chunks, p.threads) == (7, 18, 1024)
    assert p.partials == 7 * 18 * 4 * 9 * 256
    assert "window" not in wh.plan_window.__wrapped__.__code__.co_varnames


def block_rows(p, n: int, off: int, count: int, chunk: int):
    """Rows ``[r0, r1)`` that chunk ``chunk`` of every feature group scans
    for the window (off, count) over ``n`` rows, as the kernel
    (csrc/window_hist.cu) computes them on the device: an equal share of
    the clamped window."""
    lo, hi = wh.clamp_window(off, count, n)
    rows = hi - lo
    return (lo + rows * chunk // p.chunks,
            lo + rows * (chunk + 1) // p.chunks)


WINDOW = st.integers(-(1 << 21), 1 << 21)


@settings(max_examples=200, deadline=None, database=None)
@given(n=st.integers(1, 1 << 20), off=WINDOW, count=WINDOW,
       sms=st.integers(16, 160), bps=st.integers(1, 4))
@example(n=1 << 20, off=5, count=1 << 19, sms=132, bps=2)
@example(n=1000, off=0, count=1000, sms=132, bps=2)
@example(n=1000, off=-10, count=30, sms=132, bps=2)
@example(n=1000, off=990, count=100, sms=132, bps=2)
@example(n=1000, off=1005, count=10, sms=132, bps=2)
@example(n=1000, off=7, count=0, sms=132, bps=2)
@example(n=1000, off=12, count=1, sms=132, bps=2)
def test_split_covers_the_clamped_window_once(n, off, count, sms, bps):
    p = wh.plan_window(n, 28, 256, sms, bps)
    lo, hi = wh.clamp_window(off, count, n)
    assert 0 <= lo <= hi <= n
    spans = [block_rows(p, n, off, count, c) for c in range(p.chunks)]
    # consecutive, in chunk order, from lo to hi: every row once
    assert spans[0][0] == lo and spans[-1][1] == hi
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0
    assert all(r0 <= r1 for r0, r1 in spans)
    # equal shares: no chunk takes two rows more than another
    sizes = [r1 - r0 for r0, r1 in spans]
    assert max(sizes) - min(sizes) <= 1
    assert sum(sizes) == hi - lo == max(0, min(off + count, n)
                                        - min(max(off, 0), n))


def kernel_mirror(bin_words, digits, window, F, B, p):
    """The kernel's decomposition in plain PyTorch: block (chunk, group)
    sums the rows ``block_rows`` gives it for the features of bin word
    ``group`` into a partial; each output entry sums its group's partials
    in chunk order."""
    n = bin_words.shape[1]
    off, count = (int(v) for v in window)
    E = wh.WORD_FEATURES * 9 * B
    partials = torch.zeros((p.groups, p.chunks, E), dtype=torch.int32)
    bins = bin_words.t().contiguous().view(torch.uint8)       # [N, 4W]
    if digits.dtype == torch.int8:
        dig = digits
    else:
        dig = digits.t().contiguous().view(torch.int8)[:, :9]
    for g in range(p.groups):
        nf = min(wh.WORD_FEATURES, F - g * wh.WORD_FEATURES)
        for c in range(p.chunks):
            r0, r1 = block_rows(p, n, off, count, c)
            part = lh.digit_histogram_plain(
                bins[:, 4 * g:4 * g + nf].contiguous(), dig, B, r0, r1 - r0)
            partials[g, c, :nf * 9 * B] = part.reshape(-1)
    # entry e is entry e % E of group e // E: the partials' flat layout
    out = torch.zeros((p.groups, E), dtype=torch.int32)
    for c in range(p.chunks):
        out += partials[:, c]
    return out.reshape(-1)[:F * 9 * B].reshape(F, 9, B)


@pytest.mark.parametrize("F,B,off,count,matrix", [
    (28, 256, 5, 3000, False), (30, 64, -20, 900, True),
    (5, 16, 3000, 2000, False), (4, 16, 37, 0, True)])
def test_kernel_decomposition_equals_plain(F, B, off, count, matrix):
    rng = np.random.RandomState(F + B)
    n = 4000
    bins = rng.randint(0, B, size=(n, F)).astype(np.uint8)
    digits = rng.randint(-128, 128, size=(n, 9)).astype(np.int8)
    bw = pack_u8_words(torch.from_numpy(bins))
    dmat = torch.from_numpy(digits)
    dig = dmat if matrix else pack_u8_words(dmat.view(torch.uint8))
    win = torch.tensor([off, count], dtype=torch.int32)
    p = wh.plan_window(n, F, B, 16, 2)
    assert p.chunks > 1
    want = wh.window_digit_histogram_plain(bw, dig, win, F, B)
    got = kernel_mirror(bw, dig, win, F, B, p)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# P1: one permutation instead of twelve copies


def roll_chain_by_source(x: torch.Tensor) -> torch.Tensor:
    """The kernel's formulation: (key, source column) per column through
    the stages, then one gather of the 12 words."""
    key = x[0].clone()
    src = torch.arange(rc.NB)
    for s in range(rc.STAGES):
        shift = 1 << (s % 7)
        rolled_key = torch.roll(key, shift)
        rolled_src = torch.roll(src, shift)
        take = rolled_key < key
        key = torch.where(take, rolled_key, key)
        src = torch.where(take, rolled_src, src)
    out = x[:, src]
    assert torch.equal(out[0], key)
    return out


def _block(seed: int, keys=None) -> torch.Tensor:
    x = np.random.RandomState(seed).randint(
        -2**31, 2**31 - 1, (rc.WORDS, rc.NB), np.int64).astype(np.int32)
    if keys is not None:
        x[0] = keys
    return torch.from_numpy(x)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), distinct=st.integers(1, 2**31 - 1))
def test_source_formulation_on_random_inputs(seed, distinct):
    x = _block(seed)
    assert torch.equal(roll_chain_by_source(x), rc.roll_chain_plain(x))
    # few distinct keys: many ties, which never move a column
    rng = np.random.RandomState(seed)
    y = _block(seed + 1, rng.randint(0, min(distinct, 4) + 1,
                                     rc.NB).astype(np.int32))
    assert torch.equal(roll_chain_by_source(y), rc.roll_chain_plain(y))


@pytest.mark.parametrize("name", ["equal", "int_min_max", "ascending",
                                  "descending", "one_minimum"])
def test_source_formulation_on_adversarial_keys(name):
    cols = np.arange(rc.NB, dtype=np.int64)
    keys = {
        "equal": np.full(rc.NB, 7),
        "int_min_max": np.where(np.random.RandomState(3).rand(rc.NB) < 0.5,
                                -2**31, 2**31 - 1),
        "ascending": cols * 1000 - 10**6,
        "descending": -cols,
        "one_minimum": np.where(cols == 2000, -2**31, 0),
    }[name].astype(np.int32)
    x = _block(11, keys)
    want = rc.roll_chain_plain(x)
    assert torch.equal(roll_chain_by_source(x), want)
    if name == "equal":
        assert torch.equal(want, x)        # no strict compare holds
