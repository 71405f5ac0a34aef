"""The torch port's leaf histogram (lightgbm_tpu_torch/ops/leafhist.py)
against the JAX package's ops/leafhist.py.

The same numpy inputs go through both.  Digits must be exactly equal
(int8), including values at the +-half-step rounding boundaries and
negative values, and the round trip through ``combine_digit_sums`` within
1e-6 relative.  ``digit_histogram_plain`` (and the CPU path of the
``digit_histogram`` wrapper) must equal the JAX scatter version and the
Pallas kernel run in interpret mode, int32 exactly, on uint8 and uint16
bins and on windows of odd sizes.  The CUDA kernel is held against the
plain version by the ``cuda``-marked test, which skips on a host without
a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import leafhist as jlh

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import leafhist as tlh

pytestmark = pytest.mark.torch


def _gh(n, seed=0):
    rng = np.random.RandomState(seed)
    g = (rng.normal(size=n) * 3).astype(np.float32)
    h = rng.uniform(0.05, 0.3, size=n).astype(np.float32)
    w = np.ones(n, np.float32)
    return g, h, w


def _both_digits(g, h, w):
    js = jlh.compute_scales(jnp.asarray(g), jnp.asarray(h), jnp.asarray(w))
    jd = np.asarray(jlh.quantize_digits(jnp.asarray(g), jnp.asarray(h),
                                        jnp.asarray(w), js))
    tg, th, tw = (torch.from_numpy(a) for a in (g, h, w))
    ts = tlh.compute_scales(tg, th, tw)
    td = tlh.quantize_digits(tg, th, tw, ts).numpy()
    return np.asarray(js), jd, ts.numpy(), td


def test_quantize_digits_exact_on_rounding_boundaries():
    g, h, w = _gh(4000)
    scale = np.float32(4.0)
    step = scale / np.float32(1 << tlh.QBITS)
    k = np.arange(-600, 600, dtype=np.float32)
    # exact half steps (ties round to even), a hair either side of them,
    # digit-carry boundaries of the balanced radix and negative values
    edges = np.concatenate([
        (k + np.float32(0.5)) * step,
        np.nextafter((k + np.float32(0.5)) * step, np.float32(np.inf)),
        np.nextafter((k + np.float32(0.5)) * step, np.float32(-np.inf)),
        np.array([127.5, -128.5, 32767.5, -32768.5], np.float32) * step,
        np.array([scale, -scale, 0.0, -0.0], np.float32)]).astype(np.float32)
    # |g| <= scale everywhere, so the scale (max |g|) makes the steps exact
    g = np.concatenate([np.clip(g, -3.5, 3.5), edges]).astype(np.float32)
    h = np.concatenate([h, np.full(len(edges), 0.1, np.float32)])
    w = np.ones(len(g), np.float32)
    js, jd, ts, td = _both_digits(g, h, w)
    np.testing.assert_array_equal(ts, js)
    assert ts[0] == scale
    assert td.dtype == np.int8 and td.shape == (len(g), 9)
    np.testing.assert_array_equal(td, jd)
    assert (td < 0).any()


def test_combine_digit_sums_round_trip():
    g, h, w = _gh(3000, seed=1)
    _, _, ts, td = _both_digits(g, h, w)
    sums = torch.from_numpy(td.T.astype(np.int32)[:, None, :])   # [9, 1, N]
    sums = sums.permute(1, 0, 2)                                  # [1, 9, N]
    hist = tlh.combine_digit_sums(sums, torch.from_numpy(ts))[0]  # [N, 3]
    for v, x in enumerate((g, h, w)):
        np.testing.assert_allclose(hist[:, v].numpy(), x, rtol=1e-6,
                                   atol=float(ts[v]) * 2.0 ** -tlh.QBITS)
    jh = np.asarray(jlh.combine_digit_sums(jnp.asarray(sums.numpy()),
                                           jnp.asarray(ts)))
    np.testing.assert_array_equal(hist.numpy(), jh[0])


def _bins(n, f, b, dtype, seed=2):
    rng = np.random.RandomState(seed)
    return rng.randint(0, b, size=(n, f)).astype(dtype)


@pytest.mark.parametrize("dtype,b", [(np.uint8, 64), (np.uint16, 300)])
def test_plain_matches_jax_scatter_on_windows(dtype, b):
    n, f = 5000, 10
    bins = _bins(n, f, b, dtype)
    g, h, w = _gh(n, seed=3)
    _, jd, _, td = _both_digits(g, h, w)
    tb, tdig = torch.from_numpy(bins), torch.from_numpy(td)
    for start, count in ((0, n), (1, 1), (17, 4097), (n - 333, 333),
                         (2500, 0)):
        want = np.asarray(jlh.digit_histogram_scatter(
            jnp.asarray(bins[start:start + count]),
            jnp.asarray(jd[start:start + count]), b))
        got = tlh.digit_histogram_plain(tb, tdig, b, start, count)
        assert got.dtype == torch.int32 and got.shape == (f, 9, b)
        np.testing.assert_array_equal(got.numpy(), want)
        via_wrapper = tlh.digit_histogram(tb, tdig, b, start, count)
        assert torch.equal(via_wrapper, got)
        if count == 0:
            assert not got.any()


def test_plain_matches_pallas_interpret():
    n, f, b = 3000, 8, 48
    bins = _bins(n, f, b, np.uint8, seed=4)
    g, h, w = _gh(n, seed=5)
    _, jd, _, td = _both_digits(g, h, w)
    start, count = 123, 2049
    want = np.asarray(jlh.digit_histogram_pallas(
        jnp.asarray(bins[start:start + count]),
        jnp.asarray(jd[start:start + count]), b, n_blk=512,
        interpret=True))
    got = tlh.digit_histogram_plain(torch.from_numpy(bins),
                                    torch.from_numpy(td), b, start, count)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_counts_no_launch_on_cpu_and_checks_inputs():
    bins = torch.from_numpy(_bins(100, 4, 16, np.uint8))
    dig = torch.zeros((100, 9), dtype=torch.int8)
    tlh.reset_launch_counts()
    tlh.digit_histogram(bins, dig, 16)
    assert tlh.launch_counts() == {"digit_histogram": 0}
    with pytest.raises(LightGBMError, match="outside"):
        tlh.digit_histogram(bins, dig, 16, 90, 20)
    with pytest.raises(LightGBMError, match="dtype"):
        tlh.digit_histogram(bins.to(torch.int32), dig, 16)
    with pytest.raises(LightGBMError, match="must be"):
        tlh.digit_histogram(bins, dig[:, :8], 16)


def test_feature_groups_fit_shared_memory():
    assert tlh.feature_group(28, 255) == 7          # 4 groups of 7, 63 KB
    assert tlh.feature_group(30, 255) == 8          # 4 groups, last of 6
    assert tlh.feature_group(5, 255) == 5
    assert tlh.feature_group(28, 4096) == 1
    for F, B in ((28, 255), (30, 255), (3, 1024), (100, 63)):
        fg = tlh.feature_group(F, B)
        assert fg * 9 * B * 4 <= tlh.SMEM_PER_BLOCK
    with pytest.raises(LightGBMError, match="shared memory"):
        tlh.feature_group(4, 10000)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    for dtype, b in ((np.uint8, 255), (np.uint16, 300)):
        n = 70000
        bins = torch.from_numpy(_bins(n, 28, b, dtype)).to(dev)
        g, h, w = _gh(n, seed=6)
        td = torch.from_numpy(_both_digits(g, h, w)[3]).to(dev)
        for start, count in ((0, n), (5, 0), (3, 1), (11, 4097)):
            want = tlh.digit_histogram_plain(bins, td, b, start, count)
            for path in (None, "small", "large"):
                got = tlh.digit_histogram(bins, td, b, start, count,
                                          path=path)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (start, count, path)
