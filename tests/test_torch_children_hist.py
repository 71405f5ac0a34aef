"""The torch port's full-pass histograms and fused split candidates
(lightgbm_tpu_torch/ops/histogram.py, ops/children_hist.py) against the
JAX package's ops/histogram.py and ops/pallas_histogram.py.

The same numpy inputs go through both.  The Pallas kernels run as the
JAX package's own tests run them on the CPU, in interpret mode.

  * K2's plain version (``build_children_histograms``, and
    ``build_root_histogram`` for the root form) against
    ``children_histograms_pallas`` / ``root_histogram_pallas`` and the JAX
    scatter: rtol 1e-5, atol 1e-4, the JAX package's own
    kernel-against-scatter tolerance (f32 sums in another order: the
    MXU's one-hot products against a sequential scatter).
  * K3's plain version (the plain histogram and
    ``per_feature_candidates``) against
    ``fused_children_split_candidates_pallas`` on the scenarios of
    tests/test_fused_gain.py: features and thresholds exactly, gains and
    left sums to 1e-5 relative (the prefix sums associate differently:
    XLA's f32 cumulative sum against torch's f64-accumulated one on the
    CPU).
  * The dispatchers send CPU tensors to the plain versions, and the
    wrappers check their inputs.  The CUDA kernels are held against the
    plain versions by the ``cuda``-marked test, which skips without a
    card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lightgbm_tpu.ops import histogram as jhist
from lightgbm_tpu.ops.pallas_histogram import (
    children_histograms_pallas, fused_children_split_candidates_pallas,
    root_histogram_pallas)
from lightgbm_tpu.ops.split import (FeatureCandidates as JaxCandidates,
                                    SplitParams as JaxSplitParams,
                                    combine_feature_candidates as jax_combine)

from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.ops import children_hist as ch
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.split import (SplitParams,
                                          combine_feature_candidates,
                                          per_feature_candidates)

pytestmark = pytest.mark.torch

N_BLK = 256  # small kernel blocks: interpreter speed


def _rows(seed, n, f, B, dtype):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(f, n)).astype(dtype)
    g = rng.normal(size=n).astype(np.float32)
    h = (np.abs(g) + 0.1).astype(np.float32)
    w = (rng.rand(n) > 0.3).astype(np.float32)        # bagging-style mask
    leaf = rng.randint(0, 5, size=n).astype(np.int32)
    return bins, g, h, w, leaf


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("B", [16, 255])
@pytest.mark.parametrize("n", [1024, 1000, 700])
def test_children_plain_matches_pallas_and_scatter(n, B, dtype):
    bins, g, h, w, leaf = _rows(0, n, 5, B, dtype)
    got = th.build_children_histograms(*_t(bins, g, h, w, leaf), 1, 3, B)
    assert got.dtype == torch.float32 and got.shape == (2, 5, B, 3)
    jargs = [jnp.asarray(a) for a in (bins, g, h, w, leaf)]
    want = np.asarray(children_histograms_pallas(
        *jargs, 1, 3, B, n_blk=N_BLK, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    scatter = np.asarray(jhist.build_children_histograms(*jargs, 1, 3, B))
    np.testing.assert_allclose(got.numpy(), scatter, rtol=1e-5, atol=1e-4)
    # the wrapper on CPU tensors is the plain version
    via = ch.children_histograms(*_t(bins, g, h, w, leaf), 1, 3, B)
    assert torch.equal(via, got)


@pytest.mark.parametrize("dtype,B", [(np.uint8, 32), (np.uint16, 255)])
def test_root_plain_matches_pallas(dtype, B):
    bins, g, h, w, _ = _rows(1, 900, 4, B, dtype)
    got = th.build_root_histogram(*_t(bins, g, h, w), B)
    want = np.asarray(root_histogram_pallas(
        *[jnp.asarray(a) for a in (bins, g, h, w)], B, n_blk=N_BLK,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(ch.root_histogram(*_t(bins, g, h, w), B), got)
    # the root form of K2: every row in the left child, no right child
    both = th.build_children_histograms(
        *_t(bins, g, h, w, np.zeros(900, np.int32)), 0, -2, B)
    assert torch.equal(both[0], got) and not both[1].any()


# ---------------------------------------------------------------------------
# K3 on the scenarios of tests/test_fused_gain.py


def _scenario(seed=0, n=700, f=6, max_bin=21, n_cat=2):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, max_bin, size=(f, n)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.2, 1.5, size=n).astype(np.float32)
    weight = (rng.uniform(size=n) > 0.25).astype(np.float32)
    leaf_id = rng.randint(0, 3, size=n).astype(np.int32)
    num_bin = rng.randint(2, max_bin + 1, size=f).astype(np.int32)
    is_cat = np.zeros(f, bool)
    is_cat[:n_cat] = True
    return [bins, grad, hess, weight, leaf_id, num_bin, is_cat,
            np.ones(f, bool)]


def _totals(grad, hess, weight, leaf_id, parent, right):
    out = []
    for leaf in (parent, right):
        m = (leaf_id == leaf).astype(np.float32)
        out.append([np.sum(grad * weight * m, dtype=np.float32),
                    np.sum(hess * weight * m, dtype=np.float32),
                    np.sum(weight * m, dtype=np.float32)])
    return np.asarray(out, np.float32)


def _both(scn, max_bin, sp, parent=0, right=1, can=(True, True)):
    """(JAX raw [2, F, 8], port raw [2, F, 8], JAX BestSplit, port
    BestSplit) for one scenario."""
    bins, grad, hess, weight, leaf_id, num_bin, is_cat, fm = scn
    totals = _totals(grad, hess, weight, leaf_id, parent, right)
    jsp = JaxSplitParams(*sp)
    jraw = fused_children_split_candidates_pallas(
        *[jnp.asarray(a) for a in (bins, grad, hess, weight, leaf_id)],
        parent, right, jnp.asarray(totals),
        *[jnp.asarray(a) for a in (num_bin, is_cat, fm)], max_bin, jsp,
        n_blk=N_BLK, interpret=True)
    targs = _t(bins, grad, hess, weight, leaf_id)
    tt, nb, cat, mask = _t(totals, num_bin, is_cat, fm)
    traw = ch.fused_split_candidates_plain(*targs, parent, right, tt, nb,
                                           cat, mask, max_bin,
                                           SplitParams(*sp))
    # the wrapper and the dispatcher on CPU tensors are the plain version
    assert torch.equal(ch.fused_split_candidates(
        *targs, parent, right, tt, nb, cat, mask, max_bin, SplitParams(*sp)),
        traw)
    cand = th.children_split_candidates(*targs, parent, right, tt, nb, cat,
                                        mask, max_bin, SplitParams(*sp))
    for k, a in enumerate(cand):
        assert torch.equal(a.to(torch.float32), traw[:, :, k])
    jbest = jax_combine(JaxCandidates(
        gain=jraw[:, :, 0], threshold=jraw[:, :, 1].astype(jnp.int32),
        left_g=jraw[:, :, 2], left_h=jraw[:, :, 3], left_c=jraw[:, :, 4]),
        jnp.asarray(totals[:, 0]), jnp.asarray(totals[:, 1]),
        jnp.asarray(can), jsp)
    tbest = combine_feature_candidates(cand, tt[:, 0], tt[:, 1],
                                       torch.tensor(can), SplitParams(*sp))
    return np.asarray(jraw), traw.numpy(), jbest, tbest


def _assert_same(scn, max_bin, sp, **kw):
    jraw, traw, jbest, tbest = _both(scn, max_bin, sp, **kw)
    fin = np.isfinite(jraw[..., 0])
    np.testing.assert_array_equal(np.isfinite(traw[..., 0]), fin)
    np.testing.assert_array_equal(traw[..., 1], jraw[..., 1])   # thresholds
    np.testing.assert_allclose(traw[..., 0][fin], jraw[..., 0][fin],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(traw[..., 2:5], jraw[..., 2:5], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(traw[..., 5:], 0.0)
    np.testing.assert_array_equal(tbest.feature.numpy(),
                                  np.asarray(jbest.feature))
    np.testing.assert_array_equal(tbest.threshold.numpy(),
                                  np.asarray(jbest.threshold))
    ok = np.isfinite(np.asarray(jbest.gain))
    np.testing.assert_array_equal(np.isfinite(tbest.gain.numpy()), ok)
    np.testing.assert_allclose(tbest.gain.numpy()[ok],
                               np.asarray(jbest.gain)[ok], rtol=1e-5)
    return jraw, traw, jbest, tbest


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_candidates_match_pallas(seed):
    sp = (5, 1e-3, 0.0, 0.0, 0.0)
    jraw, *_ = _assert_same(_scenario(seed=seed), 21, sp)
    assert np.isfinite(jraw[..., 0]).any(), "degenerate scenario"


def test_fused_candidates_with_l1_and_min_gain():
    _assert_same(_scenario(seed=3, n=900, max_bin=17), 17,
                 (10, 0.5, 0.3, 0.7, 0.05))


def test_fused_candidates_min_data_edge():
    _assert_same(_scenario(seed=4, n=400), 21, (60, 10.0, 0.0, 0.0, 0.0))


def test_fused_candidates_all_unsplittable():
    jraw, traw, _, tbest = _assert_same(_scenario(seed=5, n=300), 21,
                                        (10_000, 10.0, 0.0, 0.0, 0.0))
    assert not np.isfinite(traw[..., 0]).any()
    np.testing.assert_array_equal(tbest.feature.numpy(), [-1, -1])
    np.testing.assert_array_equal(tbest.threshold.numpy(), [0, 0])


def test_fused_candidates_feature_mask_and_can_split():
    scn = _scenario(seed=6)
    scn[7] = np.ones(6, bool)
    scn[7][2:] = False                  # only features 0, 1 usable
    *_, tbest = _assert_same(scn, 21, (5, 1e-3, 0.0, 0.0, 0.0),
                             can=(True, False))
    assert int(tbest.feature[0]) in (-1, 0, 1)
    assert int(tbest.feature[1]) == -1


def test_fused_candidates_categorical_one_vs_rest():
    n, max_bin = 512, 8
    rng = np.random.RandomState(7)
    cats = rng.randint(0, 4, size=n)
    bins = np.stack([cats, rng.randint(0, max_bin, size=n)]).astype(np.uint8)
    grad = np.where(cats == 0, -2.0, 1.0).astype(np.float32)
    scn = [bins, grad, np.ones(n, np.float32), np.ones(n, np.float32),
           np.zeros(n, np.int32), np.asarray([4, max_bin], np.int32),
           np.asarray([True, False]), np.ones(2, bool)]
    *_, tbest = _assert_same(scn, max_bin, (5, 1e-3, 0.0, 0.0, 0.0),
                             parent=0, right=-2, can=(True, False))
    assert int(tbest.feature[0]) == 0
    assert int(tbest.threshold[0]) == 0          # "cat == 0 goes left"


# ---------------------------------------------------------------------------
# dispatch and wrapper checks


def test_dispatchers_run_plain_on_cpu_without_launches():
    bins, g, h, w, leaf = _t(*_rows(8, 800, 4, 16, np.uint8))
    ch.reset_launch_counts()
    want = th.build_children_histograms(bins, g, h, w, leaf, 1, 2, 16)
    assert torch.equal(th.children_histograms(bins, g, h, w, leaf, 1, 2, 16),
                       want)
    # 0-dim leaf tensors, as the grower passes them, give the same
    got = th.children_histograms(bins, g, h, w, leaf,
                                 torch.tensor(1, dtype=torch.int32),
                                 torch.tensor(2, dtype=torch.int32), 16)
    assert torch.equal(got, want)
    assert torch.equal(th.root_histogram(bins, g, h, w, 16),
                       th.build_root_histogram(bins, g, h, w, 16))
    totals = torch.ones((2, 3))
    nb = torch.full((4,), 16, dtype=torch.int32)
    cat, fm = torch.zeros(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool)
    sp = SplitParams(5, 1e-3)
    cand = th.children_split_candidates(bins, g, h, w, leaf, 1, 2, totals,
                                        nb, cat, fm, 16, sp)
    ref = per_feature_candidates(want, totals[:, 0], totals[:, 1],
                                 totals[:, 2], nb, cat, fm, sp)
    for a, b in zip(cand, ref):
        assert torch.equal(a, b)
    assert ch.launch_counts() == {"children_histograms": 0,
                                  "fused_split_candidates": 0}
    with pytest.raises(LightGBMError, match="EFB"):
        th.children_split_candidates(bins, g, h, w, leaf, 1, 2, totals, nb,
                                     cat, fm, 16, sp, bundle=object())


def test_wrappers_check_their_inputs():
    bins, g, h, w, leaf = _t(*_rows(9, 100, 3, 16, np.uint8))
    with pytest.raises(LightGBMError, match="dtype"):
        ch.children_histograms(bins.to(torch.int32), g, h, w, leaf, 0, 1, 16)
    with pytest.raises(LightGBMError, match="leaf_id"):
        ch.children_histograms(bins, g, h, w, leaf.long(), 0, 1, 16)
    with pytest.raises(LightGBMError, match="grad"):
        ch.children_histograms(bins, g[:50], h, w, leaf, 0, 1, 16)
    with pytest.raises(LightGBMError, match="contiguous"):
        ch.children_histograms(bins.T.contiguous().T, g, h, w, leaf, 0, 1, 16)
    with pytest.raises(LightGBMError, match="totals"):
        ch.fused_split_candidates(
            bins, g, h, w, leaf, 0, 1, torch.ones(3),
            torch.full((3,), 16, dtype=torch.int32),
            torch.zeros(3, dtype=torch.bool),
            torch.ones(3, dtype=torch.bool), 16, SplitParams())


def test_k2_launch_plan_is_k3s_and_refuses_what_cannot_fit():
    # K2 and K3 share one kernel body and one plan: the occupancy query
    # sees the plan's shared bytes, and the plan is plan_fused's
    for F, B in ((28, 255), (30, 1000), (5, 255), (3, 4096)):
        seen = []

        def occupancy(smem):
            seen.append(smem)
            return 1, 132
        p = ch.launch_plan(F, B, occupancy)
        assert p == ch.plan_fused(F, B, 132, 1)
        assert seen == [p.smem] and p.smem <= ch.SMEM_LIMIT
    assert ch.launch_plan(28, 255, lambda smem: (1, 132)).grid == 132
    too_wide = (ch.SMEM_LIMIT - ch.FUSED_QUEUE_BYTES) // 24 + 1
    with pytest.raises(LightGBMError, match="shared memory"):
        ch.launch_plan(4, too_wide, lambda smem: (1, 132))
    with pytest.raises(LightGBMError, match="resident"):
        ch.launch_plan(28, 255, lambda smem: (0, 132))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_root_form_without_leaf_array_equals_zero_leaf_form(dtype):
    # root_histogram hands the kernel no leaf array (every row in the left
    # child); on the plain path it equals the children histogram of an
    # all-zeros leaf array with leaf 0 on the left and no right child
    bins, g, h, w, _ = _t(*_rows(12, 3000, 6, 200, dtype))
    zeros = torch.zeros(bins.shape[1], dtype=torch.int32)
    got = ch.root_histogram(bins, g, h, w, 200)
    two = ch.children_histograms(bins, g, h, w, zeros, 0, -2, 200)
    torch.testing.assert_close(got, two[0], rtol=0, atol=0)
    assert not bool(two[1].any())
    with pytest.raises(LightGBMError, match="weight"):
        ch.root_histogram(bins, g, h, w[:10], 200)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    for dtype, B in ((np.uint8, 255), (np.uint16, 1000)):
        rows = _rows(10, 70000, 28, B, dtype)
        bins, g, h, w, leaf = (t.to(dev) for t in _t(*rows))
        got = ch.children_histograms(bins, g, h, w, leaf, 1, 3, B)
        want = ch.build_children_histograms(bins, g, h, w, leaf, 1, 3, B)
        scale = ch.build_children_histograms(bins, g.abs(), h.abs(),
                                             w.abs(), leaf, 1, 3, B)
        torch.cuda.synchronize()
        assert bool(((got - want).abs()
                     <= ch.HIST_RTOL * scale + ch.HIST_ATOL).all())
        totals = torch.from_numpy(_totals(*rows[1:], 1, 3)).to(dev)
        nb = torch.full((28,), B, dtype=torch.int32, device=dev)
        cat = torch.zeros(28, dtype=torch.bool, device=dev)
        fm = torch.ones(28, dtype=torch.bool, device=dev)
        args = (bins, g, h, w, leaf, 1, 3, totals, nb, cat, fm, B,
                SplitParams(50, 1e-3))
        p3 = ch.fused_split_candidates_plain(*args)
        t = p3[..., 1].long().clamp(min=0)[..., None, None].expand(
            -1, -1, 1, 3)
        at_t = scale.cumsum(dim=2).gather(2, t)[:, :, 0]      # [2, F, 3]
        tol = ch.gain_tolerance(p3[..., 2], p3[..., 3], totals[:, 0, None],
                                totals[:, 1, None], at_t[..., 0],
                                at_t[..., 1])
        fin = torch.isfinite(p3[..., 0])
        k3 = ch.fused_split_candidates(*args)
        torch.cuda.synchronize()
        assert torch.equal(torch.isfinite(k3[..., 0]), fin)
        same = (k3[..., 1] == p3[..., 1]) & fin
        assert bool(((k3[..., 0] - p3[..., 0]).abs()[same]
                     <= tol[same]).all())
