"""The torch port's device-windowed digit histogram P2
(lightgbm_tpu_torch/ops/window_hist.py, tools/probe_dynhist.py) and its
word packing (ops/ordered_grow.py ``pack_u8_words``/``unpack_words``)
against the JAX package's TPU probe tools/probe_dynhist.py and
ops/ordered_grow.py.

Each of the probe's three kernel bodies (``make_variant``: laneconcat,
subconcat_T, digmat) runs in interpret mode inside a
``PrefetchScalarGridSpec`` call built here as the probe's ``run`` builds
it, at N = 2^14 rows and nb = 2048, on windows whose blocks lie inside
N.  The same numpy inputs go to both sides and every comparison is exact
(int32 digit sums, int32 words).  The plain version is also held against
K1's plain version on the unpacked window at the edges (a window ending
at N, one clamped past N or below 0, bin 255).  The words of each kind
go to the port stacked as the rows of one buffer.  The CUDA kernel is
held against the plain version and K1, with one kernel launch a call and
nothing zero-filled before it, by the ``cuda``-marked test, which skips
on a host without a card.
"""

import json
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from lightgbm_tpu.ops import ordered_grow as jog
from tools import probe_dynhist as jprobe

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import leafhist as tlh
from lightgbm_tpu_torch.ops import ordered_grow as tog
from lightgbm_tpu_torch.ops import window_hist as wh
from lightgbm_tpu_torch.tools import probe_dynhist as tprobe

pytestmark = pytest.mark.torch

N = 1 << 14
NB = 2048
F, B = tprobe.F, tprobe.B
# (off, count): the probe's first window, one at 0, a 1-row window at a
# block's last row, and an empty one; every block they touch is inside N
JAX_WINDOWS = ((5, N // 2), (0, N // 2), (NB - 1, 1), (100, 0))


@pytest.fixture(scope="module")
def inputs():
    bins, digits = tprobe.make_inputs(N)
    bw, dw, dmat = tprobe.device_inputs(bins, digits, "cpu")
    return {"bins": bins, "digits": digits, "bw": bw, "dw": dw,
            "dmat": dmat}


def _window(off, count):
    return torch.tensor([off, count], dtype=torch.int32)


def _jax_call(name, matrix):
    """The probe's kernel body ``name`` in a scalar-prefetch call built as
    ``probe_dynhist.run`` builds it (probe_dynhist.py:128-151), in
    interpret mode."""
    kernel = jprobe.make_variant(name, NB)
    in_specs = [pl.BlockSpec((NB,), lambda i, s: (s[0] + i,))
                for _ in range(jprobe.W)]
    if matrix:
        in_specs += [pl.BlockSpec((NB, 9), lambda i, s: (s[0] + i, 0))]
    else:
        in_specs += [pl.BlockSpec((NB,), lambda i, s: (s[0] + i,))
                     for _ in range(3)]

    @jax.jit
    def call(off, scnt, *ops):
        off0 = off // NB
        shift = off - off0 * NB
        nblocks = jnp.maximum((shift + scnt + NB - 1) // NB, 1)
        scalars = jnp.stack([off0, shift, scnt]).astype(jnp.int32)
        gs = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nblocks,), in_specs=in_specs,
            out_specs=pl.BlockSpec((F, 9, B), lambda i, s: (0, 0, 0)),
            scratch_shapes=[pltpu.VMEM((F, 9, B), jnp.int32)])
        return pl.pallas_call(
            kernel, grid_spec=gs,
            out_shape=jax.ShapeDtypeStruct((F, 9, B), jnp.int32),
            interpret=True)(scalars, *ops)
    return call


@pytest.mark.parametrize("c", [28, 9, 5, 1])
def test_pack_words_bit_equal_to_jax(c):
    rng = np.random.RandomState(c)
    x = rng.randint(0, 256, size=(1000, c)).astype(np.uint8)
    want = [np.asarray(w) for w in jog.pack_u8_words(jnp.asarray(x))]
    got = tog.pack_u8_words(torch.from_numpy(x))
    # the [W, N] buffer window_digit_histogram takes, no stacking
    assert got.shape == (len(want), 1000) and got.is_contiguous()
    assert len(got) == len(want) == -(-c // 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)
    back = tog.unpack_words(got, c)
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jog._unpack_words(
            tuple(jnp.asarray(w) for w in want), c)))
    # byte f % 4 of word f // 4 sits at bits 8 * (f % 4)
    f = c - 1
    np.testing.assert_array_equal(
        (got[f // 4].numpy() >> (8 * (f % 4))) & 0xFF, x[:, f])


def test_inputs_match_the_probe(inputs):
    rng = np.random.RandomState(0)
    bins = rng.randint(0, B - 1, size=(N, F)).astype(np.uint8)
    digits = rng.randint(-128, 127, size=(N, 9)).astype(np.int8)
    np.testing.assert_array_equal(inputs["bins"], bins)
    np.testing.assert_array_equal(inputs["digits"], digits)
    want = jog.pack_u8_words(jax.lax.bitcast_convert_type(
        jnp.asarray(digits), jnp.uint8))
    for g, w in zip(inputs["dw"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name,matrix", [("laneconcat", False),
                                         ("subconcat_T", False),
                                         ("digmat", True)])
def test_plain_matches_jax_variant(inputs, name, matrix):
    call = _jax_call(name, matrix)
    jbw = tuple(jnp.asarray(w.numpy()) for w in inputs["bw"])
    jdig = (jnp.asarray(inputs["digits"]),) if matrix else \
        tuple(jnp.asarray(w.numpy()) for w in inputs["dw"])
    digits = inputs["dmat"] if matrix else inputs["dw"]
    for off, count in JAX_WINDOWS:
        want = np.asarray(call(jnp.int32(off), jnp.int32(count), *jbw,
                               *jdig))
        got = wh.window_digit_histogram_plain(inputs["bw"], digits,
                                              _window(off, count), F, B)
        assert got.dtype == torch.int32 and tuple(got.shape) == (F, 9, B)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.any() == (count > 0)


@pytest.mark.parametrize("matrix", [False, True])
def test_plain_equals_k1_on_the_unpacked_window(inputs, matrix):
    bins = inputs["bins"].copy()
    bins[N - 7, 3] = 255                  # above the probe's 0..254
    bins[2, 27] = 255
    tb = torch.from_numpy(bins)
    bw = tog.pack_u8_words(tb)
    digits = inputs["dmat"] if matrix else inputs["dw"]
    td = inputs["dmat"]
    for off, count, lo, hi in ((N - 100, 100, N - 100, N),    # ends at N
                               (N - 50, 200, N - 50, N),      # past N
                               (-10, 30, 0, 20),              # below 0
                               (N + 5, 10, N, N),             # all past N
                               (0, N, 0, N),
                               (1, 2, 1, 3)):                 # bin 255
        got = wh.window_digit_histogram_plain(bw, digits,
                                              _window(off, count), F, B)
        want = tlh.digit_histogram_plain(tb, td, B, lo, hi - lo)
        assert torch.equal(got, want), (off, count)
        via_wrapper = wh.window_digit_histogram(bw, digits,
                                                _window(off, count), F, B)
        assert torch.equal(via_wrapper, got)
    got = wh.window_digit_histogram_plain(bw, digits, _window(N - 10, 10),
                                          F, B)
    assert got[3, :, 255].any()
    # bin 255 against a numpy bincount
    rows = slice(N - 10, N)
    want = np.bincount(bins[rows, 3], weights=inputs["digits"][rows, 0],
                       minlength=256)
    np.testing.assert_array_equal(got[3, 0].numpy(), want.astype(np.int32))


def test_wrapper_on_cpu_counts_nothing_and_checks_inputs(inputs):
    bw, dw, dmat = inputs["bw"], inputs["dw"], inputs["dmat"]
    win = _window(5, 100)
    wh.reset_launch_counts()
    wh.window_digit_histogram(bw, dw, win, F, B)
    assert wh.launch_counts() == {"window_digit_histogram": 0}
    with pytest.raises(LightGBMError, match="window must be"):
        wh.window_digit_histogram(bw, dw, win.to(torch.int64), F, B)
    with pytest.raises(LightGBMError, match="window must be"):
        wh.window_digit_histogram(bw, dw, win[:1], F, B)
    with pytest.raises(LightGBMError, match="bin words"):
        wh.window_digit_histogram(bw[:6], dw, win, F, B)
    with pytest.raises(LightGBMError, match="digit words"):
        wh.window_digit_histogram(bw, dw[:2], win, F, B)
    with pytest.raises(LightGBMError, match="digit matrix"):
        wh.window_digit_histogram(bw, dmat[:, :8], win, F, B)
    with pytest.raises(LightGBMError, match="max_bin"):
        wh.window_digit_histogram(bw, dw, win, F, 257)
    with pytest.raises(LightGBMError, match="contiguous"):
        wh.window_digit_histogram(bw, dw.to(torch.int64), win, F, B)
    with pytest.raises(LightGBMError, match="contiguous"):
        wh.window_digit_histogram(bw.t().contiguous().t(), dw, win, F, B)
    with pytest.raises(LightGBMError, match="contiguous"):
        wh.window_digit_histogram(bw, dw.t().contiguous().t(), win, F, B)


def test_cpu_entry_point_prints_its_json_line(capsys, inputs):
    res = tprobe.main(["--device", "cpu", "--rows", str(N)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(tprobe.RUNS) + 1
    assert json.loads(lines[-1]) == res
    assert res["device"] == "cpu" and res["window"] == N // 2
    assert [(r["name"], r["nb"]) for r in res["runs"]] == [
        (name, nb) for name, nb, _ in tprobe.RUNS]
    # the TPU's nb sets nothing on the card: the words runs time one
    # kernel, the matrix runs another
    assert res["nb"] == tprobe.NB_ON_CARD
    assert [r.get("same_as") for r in res["runs"]] == [
        None, "laneconcat nb=2048", "laneconcat nb=2048", None,
        "digmat nb=8192"]
    assert all(r["plan"] is None for r in res["runs"])
    # the chained offsets, replayed on the host: every layout agrees
    # (the second loop starts from the first one's last window and sums
    # out[0, 0, 1] over its calls)
    win, acc = _window(5, N // 2), 0
    for call in range(2 * tprobe.CALLS):
        o = tlh.digit_histogram_plain(
            torch.from_numpy(inputs["bins"]), inputs["dmat"], B,
            int(win[0]), N // 2)
        win = _window(int(o[0, 0, 0]) % 128, N // 2)
        if call >= tprobe.CALLS:
            acc += int(o[0, 0, 1])
    for r in res["runs"]:
        assert r["last_off"] == int(win[0]) and r["acc"] == acc
        assert r["ms_per_call"] > 0


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(LightGBMError, match="no CUDA device"):
        tprobe.run(rows=N)


@pytest.mark.cuda
def test_kernel_matches_plain_and_k1_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    n = 1 << 17
    bins, digits = tprobe.make_inputs(n)
    bins[n - 1, 5] = 255
    bw, dw, dmat = tprobe.device_inputs(bins, digits, dev)
    tb = torch.from_numpy(bins).to(dev)
    for off, count in ((5, n // 2), (0, 0), (4097, 1), (n - 3000, 3000),
                       (n - 10, 500), (1000, 70000), (-50, 100)):
        win = torch.tensor([off, count], dtype=torch.int32, device=dev)
        lo = min(max(off, 0), n)
        hi = min(max(off + count, lo), n)
        k1 = tlh.digit_histogram(tb, dmat, B, lo, hi - lo)
        for digits_in in (dw, dmat):
            want = wh.window_digit_histogram_plain(bw, digits_in, win, F, B)
            wh.reset_launch_counts()
            got = wh.window_digit_histogram(bw, digits_in, win, F, B)
            torch.cuda.synchronize()
            assert wh.launch_counts() == {"window_digit_histogram": 1}
            assert torch.equal(got, want), (off, count)
            assert torch.equal(got, k1)
    # one call: its kernel once and no other device work (no memset, no
    # fill); the profiler does not record every call, so it is asked up
    # to ten times, and a call it never records fails the test
    win = torch.tensor([5, n // 2], dtype=torch.int32, device=dev)
    for digits_in in (dw, dmat):
        wh.window_digit_histogram(bw, digits_in, win, F, B)
        torch.cuda.synchronize()
        acts = {}
        for _ in range(10):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wh.window_digit_histogram(bw, digits_in, win, F, B)
                torch.cuda.synchronize()
            acts = {e.key: e.count for e in prof.key_averages()
                    if (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0)) > 0}
            if acts:
                break
            time.sleep(0.2)
        assert acts, "the profiler recorded no device activity"
        assert list(acts.values()) == [1], acts
        assert all("window_hist_kernel" in k for k in acts), acts
