"""The torch port's roll-chain kernel P1 (lightgbm_tpu_torch/ops/roll_chain.py
and tools/probe_roll.py) against the JAX package's TPU probe
tools/probe_roll.py.

The probe's Pallas ``kernel`` runs in interpret mode inside a
``pl.pallas_call`` built here with the probe's ``BlockSpec``s.  The same
numpy inputs go to both sides and every comparison is exact (int32
words): the probe's seeded input and two more seeds, and a 3-call chain
of the probe's loop body ``call(acc) ^ 1``.  The roll direction is pinned
on a hand-made input and against ``np.roll``.  The CUDA kernel is held
against the plain version by the ``cuda``-marked test, which skips on a
host without a card, also on adversarial keys (all equal, only INT_MIN
and INT_MAX, sorted either way).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from tools import probe_roll as jprobe

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import roll_chain as rc
from lightgbm_tpu_torch.tools import probe_roll as tprobe

pytestmark = pytest.mark.torch

SHAPE = (rc.WORDS, rc.NB)


@pytest.fixture(scope="module")
def jax_call():
    """The probe's kernel in interpret mode, compiled once (XLA's CPU
    backend at optimization level 0: the 28 x 13 rolls take seconds to
    compile at the default level)."""
    call = pl.pallas_call(
        jprobe.kernel,
        in_specs=[pl.BlockSpec((jprobe.WORDS, jprobe.NB), lambda: (0, 0))],
        out_specs=pl.BlockSpec((jprobe.WORDS, jprobe.NB), lambda: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((jprobe.WORDS, jprobe.NB),
                                       jnp.int32),
        interpret=True)
    spec = jax.ShapeDtypeStruct((jprobe.WORDS, jprobe.NB), jnp.int32)
    return jax.jit(call).lower(spec).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _seeded(seed):
    rng = np.random.RandomState(seed)
    return rng.randint(-2**31, 2**31 - 1, SHAPE, np.int64).astype(np.int32)


def _numpy_chain(x):
    words = x.copy()
    for s in range(rc.STAGES):
        rolled = np.roll(words, 1 << (s % 7), axis=1)
        words = np.where((rolled[0] < words[0])[None, :], rolled, words)
    return words


def test_constants_and_input_match_the_probe():
    assert (rc.STAGES, rc.WORDS, rc.NB) == (jprobe.STAGES, jprobe.WORDS,
                                            jprobe.NB)
    x = tprobe.make_input()
    np.testing.assert_array_equal(x, _seeded(0))
    assert x.min() < -2**30 and x.max() > 2**30      # full signed range


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_kernel(jax_call, seed):
    x = _seeded(seed)
    want = np.asarray(jax_call(jnp.asarray(x)))
    got = rc.roll_chain_plain(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == SHAPE
    np.testing.assert_array_equal(got.numpy(), want)
    # the interpreted pltpu.roll rolls as np.roll does
    np.testing.assert_array_equal(want, _numpy_chain(x))
    assert not np.array_equal(want, x)


def test_chain_matches_jax_loop_body(jax_call):
    x = _seeded(0)
    acc = jnp.asarray(x)
    for _ in range(3):
        acc = jax_call(acc) ^ 1                   # probe_roll.py:55
    got = tprobe.chain(torch.from_numpy(x), calls=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))


def test_roll_direction_on_a_hand_made_input(jax_call):
    """One column with the smallest key spreads to higher column indices
    (out[i] takes x[i - shift]), never across the wrap to column 2047."""
    x = np.zeros(SHAPE, np.int32)
    x[1:] = np.arange(rc.NB, dtype=np.int32)[None, :] * 100 + \
        np.arange(1, rc.WORDS, dtype=np.int32)[:, None]
    x[0, 0] = -1
    got = rc.roll_chain_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_call(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:, 1], x[:, 0])   # rolled by +1 first
    assert got[0, rc.NB - 1] == 0
    np.testing.assert_array_equal(got[:, rc.NB - 1], x[:, rc.NB - 1])
    # one stage by hand: shift 1 moves column 0 into column 1
    rolled = torch.roll(torch.from_numpy(x), 1, dims=1)
    assert rolled[0, 1] == -1 and rolled[0, 0] == 0


def test_wrapper_on_cpu_runs_plain_and_checks_inputs():
    x = torch.from_numpy(_seeded(3))
    rc.reset_launch_counts()
    assert torch.equal(rc.roll_chain(x), rc.roll_chain_plain(x))
    assert rc.launch_counts() == {"roll_chain": 0}
    with pytest.raises(LightGBMError, match="expected"):
        rc.roll_chain(x[:, :1024].contiguous())
    with pytest.raises(LightGBMError, match="expected"):
        rc.roll_chain(x.to(torch.int64))
    with pytest.raises(LightGBMError, match="contiguous"):
        rc.roll_chain(x.t().contiguous().t())


def test_cpu_entry_point_prints_its_json_line(capsys):
    res = tprobe.main(["--device", "cpu", "--reps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("build+run ")
    assert "us/block" in lines[1] and "ns/row" in lines[1]
    assert json.loads(lines[-1]) == res
    assert res["device"] == "cpu" and res["clock"] == "host"
    assert (res["stages"], res["words"], res["nb"], res["chain"]) == (
        28, 12, 2048, 50)
    assert res["us_per_call"] > 0 and res["kernel_us"] > 0
    # two 50-call chains from the seeded input
    x = torch.from_numpy(_seeded(0))
    want = tprobe.chain(tprobe.chain(x))
    assert res["checksum"] == int(want.to(torch.int64).sum())


def test_entry_point_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(LightGBMError, match="no CUDA device"):
        tprobe.run()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(7)
    keys = (np.full(rc.NB, 3, np.int32),                      # all equal
            np.where(rng.rand(rc.NB) < 0.5, np.int32(-2**31),
                     np.int32(2**31 - 1)).astype(np.int32),
            np.arange(rc.NB, dtype=np.int32),                 # sorted
            -np.arange(rc.NB, dtype=np.int32))
    inputs = [_seeded(seed) for seed in (0, 1, 2)]
    for k in keys:
        x = _seeded(9)
        x[0] = k
        inputs.append(x)
    for x in inputs:
        x = torch.from_numpy(x).to(dev)
        rc.reset_launch_counts()
        got = rc.roll_chain(x)
        torch.cuda.synchronize()
        assert rc.launch_counts() == {"roll_chain": 1}
        assert torch.equal(got, rc.roll_chain_plain(x))
    x = torch.from_numpy(_seeded(0)).to(dev)
    acc, want = x, x
    for _ in range(tprobe.CHAIN):
        acc = rc.roll_chain(acc) ^ 1
        want = rc.roll_chain_plain(want) ^ 1
    assert torch.equal(acc, want)
    # the floor's empty kernel launches and counts nothing
    rc.reset_launch_counts()
    rc.empty_launches(dev, 10)
    torch.cuda.synchronize()
    assert rc.launch_counts() == {"roll_chain": 0}
