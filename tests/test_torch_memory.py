"""The port's device-memory gate (``models/gbdt.py``
``_check_memory_budget``, ``utils/resource.py``) and its OOM guard
against the JAX package's, under the same ``LGBT_DEVICE_MEMORY_BYTES``.

The estimate's components that have the same buffers in both packages
equal JAX ``estimate_train_memory`` by name; a budget below the estimate
refuses with the component table before training allocates; the ladder
takes the JAX package's steps in its order (``score_donation`` is
unavailable in both here: the port updates in place, the JAX package's
CPU aliasing is unsafe); a degraded booster grows the cached booster's
trees; a late valid set is re-checked; ``reset_training_data`` runs the
gate again; an allocation failure in a named unit becomes a
``DeviceOOM`` after which the booster trains on.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu.models import gbdt as jgbdt
from lightgbm_tpu.utils import resource as jresource

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import obs
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.models import gbdt
from lightgbm_tpu_torch.testing import faults
from lightgbm_tpu_torch.utils import resource
from lightgbm_tpu_torch.utils.log import LightGBMError

CPU = torch.device("cpu")
PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
          "min_data_in_leaf": 5, "min_sum_hessian_in_leaf": 1e-3,
          "verbose": -1}


def _xy(n=2000, f=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return X, y


def _datasets(n=2000, f=10, seed=0):
    X, y = _xy(n, f, seed)
    kw = dict(max_bin=255, min_data_in_leaf=5)
    return BinnedDataset.from_matrix(X, y, **kw), \
        JBinned.from_matrix(X, y, **kw)


def _both(params, limit, monkeypatch, n=2000):
    """(port booster or its error, JAX booster or its error) under
    ``LGBT_DEVICE_MEMORY_BYTES=limit`` (None: unset)."""
    if limit is None:
        monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES", raising=False)
    else:
        monkeypatch.setenv("LGBT_DEVICE_MEMORY_BYTES", str(int(limit)))
    ds, jds = _datasets(n)
    out = []
    for build in (lambda: gbdt.GBDT(Config(params), ds, CPU),
                  lambda: jgbdt.GBDT(JConfig(params), jds)):
        try:
            out.append(build())
        except (LightGBMError, jresource.LightGBMError) as exc:
            out.append(exc)
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(leaf_cache=False),
    dict(leaf_cache=False, fused_scratch=True),
    dict(linear_k=4),
    dict(bin_itemsize=2, linear_k=2),
])
@pytest.mark.parametrize("rows", [100_000, 4097])
def test_shared_components_equal_jax_by_name(kw, rows):
    args = (rows, 28, 63, 255, 3)
    ours = gbdt.estimate_train_memory(*args, **kw)
    # the port's score update is in place: the JAX term under donation
    theirs = jgbdt.estimate_train_memory(*args, donate_score=True, **kw)
    assert set(ours) == set(theirs)
    for key in ("bins_device", "scores_and_gradients", "score_double_buffer",
                "histogram_cache", "vmem_scratch", "linear_fit"):
        assert ours[key] == theirs[key], key
    # the port's own buffers are summed in its total
    assert ours["total"] == sum(v for k, v in ours.items() if k != "total")
    # K2's partials on a card are counted on top of the JAX scratch
    card = gbdt.estimate_train_memory(*args, scratch_blocks=132, **kw)
    assert card["vmem_scratch"] == ours["vmem_scratch"] \
        + 132 * 2 * 28 * 255 * 3 * 8 + 2 * 28 * 255 * 3 * 4
    assert gbdt.estimate_valid_memory(5000, 28, 3, 2) == \
        jgbdt.estimate_valid_memory(5000, 28, 3, 2)


def test_fail_fast_refuses_with_the_table(monkeypatch):
    port, jax_ = _both(PARAMS, 100_000, monkeypatch)
    assert isinstance(port, resource.MemoryBudgetExceeded)
    assert isinstance(jax_, jresource.MemoryBudgetExceeded)
    for err in (port, jax_):
        assert err.limit == 100_000 and err.steps_taken == ()
        assert "exceeds the device budget" in str(err)
        for key in ("bins_device", "histogram_cache", "packed_payload",
                    "score_double_buffer", "working"):
            assert f"{key}=" in str(err)
    assert set(port.estimate) == set(jax_.estimate)
    # the gauges and the table for a later OOM diagnosis
    assert obs.get_gauge("hbm_budget_bytes") == 100_000
    assert resource.budget_table()["total"] == port.estimate["total"]


def _floors(monkeypatch):
    """(port, JAX) estimates with the cache and without it."""
    full = _both(PARAMS, None, monkeypatch)
    nocache = _both(dict(PARAMS, histogram_pool_size=0.001,
                         memory_policy="degrade"), None, monkeypatch)
    return ([b._train_mem_est for b in full],
            [b._train_mem_est for b in nocache])


def test_ladder_takes_the_jax_steps_in_order(monkeypatch):
    (full_p, full_j), (floor_p, floor_j) = _floors(monkeypatch)
    limit = max(floor_p, floor_j) + 1
    assert limit < min(full_p, full_j)
    params = dict(PARAMS, memory_policy="degrade")
    c0 = obs.get_counter("resource_degrade_total")
    port, jax_ = _both(params, limit, monkeypatch)
    assert port._degrade_steps == jax_._degrade_steps == ("hist_cache",)
    assert port.grow_kind == "nocache"
    assert obs.get_counter("resource_degrade_total") - c0 == 1
    assert obs.get_counter("resource_degrade_hist_cache") >= 1
    # below both floors: every available step, then the refusal
    port, jax_ = _both(params, 10_000, monkeypatch)
    assert isinstance(port, resource.MemoryBudgetExceeded)
    assert isinstance(jax_, jresource.MemoryBudgetExceeded)
    assert port.steps_taken == jax_.steps_taken == ("hist_cache", "row_pad")
    assert "Degrade ladder already applied: hist_cache, row_pad" in str(port)
    assert resource.DEGRADE_STEPS == jresource.DEGRADE_STEPS


def test_degraded_booster_grows_the_cached_trees(monkeypatch):
    (_, _), (floor_p, _) = _floors(monkeypatch)
    ds, _ = _datasets()
    monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES", raising=False)
    cached = gbdt.GBDT(Config(dict(PARAMS, serial_grow="cached")), ds, CPU)
    monkeypatch.setenv("LGBT_DEVICE_MEMORY_BYTES", str(floor_p + 1))
    degraded = gbdt.GBDT(Config(dict(PARAMS, serial_grow="cached",
                                     memory_policy="degrade")), ds, CPU)
    assert degraded._degrade_steps == ("hist_cache",)
    for b in (cached, degraded):
        for _ in range(3):
            b.train_one_iter()
    for a, b in zip(cached.models, degraded.models):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_array_equal(a.threshold_in_bin, b.threshold_in_bin)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-4,
                                   atol=1e-7)


@pytest.mark.parametrize("policy", ["degrade", "fail_fast"])
def test_histogram_pool_size_as_in_jax(monkeypatch, policy):
    params = dict(PARAMS, histogram_pool_size=1.0, memory_policy=policy)
    port, jax_ = _both(params, None, monkeypatch)
    want = ("hist_cache",) if policy == "degrade" else ()
    assert port._degrade_steps == jax_._degrade_steps == want
    assert port.grow_kind == ("nocache" if want else "ordered")


def test_late_valid_set_is_rechecked(monkeypatch):
    monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES", raising=False)
    X, y = _xy()
    Xv, yv = _xy(1500, seed=1)
    ds = BinnedDataset.from_matrix(X, y, max_bin=255, min_data_in_leaf=5)
    jds = JBinned.from_matrix(X, y, max_bin=255, min_data_in_leaf=5)
    port = gbdt.GBDT(Config(PARAMS), ds, CPU)
    jax_ = jgbdt.GBDT(JConfig(PARAMS), jds)
    # room for the training state and not for the valid set
    for b, valid in ((port, ds.create_valid(Xv, yv)),
                     (jax_, jds.create_valid(Xv, yv))):
        monkeypatch.setenv("LGBT_DEVICE_MEMORY_BYTES",
                           str(b._train_mem_est + 1000))
        with pytest.raises((LightGBMError, jresource.LightGBMError),
                           match="attaching this validation set.*over the "
                                 "budget"):
            b.add_valid_dataset(valid)
    assert obs.get_gauge("hbm_total_estimate_bytes") > port._train_mem_est
    monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES")
    port.add_valid_dataset(ds.create_valid(Xv, yv))
    assert port._valid_mem_bytes == gbdt.estimate_valid_memory(
        1500, ds.num_columns, 1)["total"]


def test_reset_training_data_reruns_the_gate(monkeypatch):
    monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES", raising=False)
    X, y = _xy()
    ds = BinnedDataset.from_matrix(X, y, max_bin=255, min_data_in_leaf=5)
    b = gbdt.GBDT(Config(dict(PARAMS, memory_policy="degrade")), ds, CPU)
    for _ in range(2):
        b.train_one_iter()
    X2, y2 = _xy(4000, seed=2)
    bigger = ds.create_valid(X2, y2)
    (_, _), (floor_p, _) = _floors(monkeypatch)
    monkeypatch.setenv("LGBT_DEVICE_MEMORY_BYTES", str(2 * floor_p))
    b.reset_training_data(bigger)
    assert b._degrade_steps == ("hist_cache",)
    assert b.grow_kind == "nocache" and b.num_data == 4000
    # the replayed scores are the two trees' predictions on the new rows
    want = sum(t.predict(X2) for t in b.models)
    np.testing.assert_allclose(b.train_data.host_score()[0], want,
                               rtol=0, atol=1e-5)
    assert not b.train_one_iter()
    monkeypatch.setenv("LGBT_DEVICE_MEMORY_BYTES", "10000")
    with pytest.raises(resource.MemoryBudgetExceeded):
        b.reset_training_data(bigger)


def _booster(extra=None, valid=False):
    X, y = _xy()
    params = dict(PARAMS, num_leaves=15, **(extra or {}))
    ds = lt.Dataset(X, y, params=params)
    b = lt.Booster(params=params, train_set=ds, device="cpu")
    if valid:
        Xv, yv = _xy(500, seed=3)
        b.add_valid(ds.create_valid(Xv, yv), "v")
    return b, X


@pytest.mark.parametrize("program,extra", [
    ("train_step", None),
    ("train_gradients", None),
    ("bag_mask", {"bagging_fraction": 0.7, "bagging_freq": 1}),
    ("score_update", None),
    ("valid_replay", None),
    ("linear_fit", {"linear_tree": True}),
])
def test_injected_oom_is_named_and_training_goes_on(monkeypatch, program,
                                                    extra):
    monkeypatch.delenv("LGBT_DEVICE_MEMORY_BYTES", raising=False)
    b, _ = _booster(extra, valid=True)
    ref, _ = _booster(extra, valid=True)
    b.update()
    ref.update()
    c0 = obs.get_counter("device_oom_total")
    with faults.oom_on_program(program) as stats:
        with pytest.raises(resource.DeviceOOM) as ei:
            b.update()
    assert stats["fired"] == 1
    err = ei.value
    assert isinstance(err, LightGBMError)
    assert err.program == program and program in str(err)
    assert "f32[" in err.shapes or "u8[" in err.shapes
    assert "admission estimate" in str(err) and "bins_device" in str(err)
    assert "memwatch" in str(err)
    assert obs.get_counter("device_oom_total") - c0 == 1
    assert obs.get_counter("device_oom_" + program) >= 1
    # nothing of the round was committed: the booster trains on
    gb = b._booster
    assert gb.iter_ == 1 and len(gb.models) == 1
    for _ in range(2):
        b.update()
        ref.update()
    if program != "bag_mask":
        # the same trees as a run that never failed (the bag draw
        # advanced its key before failing, as the JAX package's does)
        for t, r in zip(gb.models, ref._booster.models):
            np.testing.assert_array_equal(t.split_feature, r.split_feature)
            np.testing.assert_allclose(t.leaf_value, r.leaf_value)
        np.testing.assert_allclose(gb.valid_data[0].host_score(),
                                   ref._booster.valid_data[0].host_score())
    assert len(gb.models) == 3


def test_injected_oom_in_predict(monkeypatch):
    b, X = _booster()
    b.update()
    want = b.predict(X[:10])
    with faults.oom_on_program("predict"):
        with pytest.raises(resource.DeviceOOM, match="'predict'") as ei:
            b.predict(X[:10])
    assert "f64[" in ei.value.shapes
    np.testing.assert_array_equal(b.predict(X[:10]), want)


def test_classifier_takes_only_allocation_failures():
    for exc in (torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2 GiB"),
                RuntimeError("CUDA out of memory. Tried to allocate 8 MiB"),
                RuntimeError("CUDA error: out of memory"),
                MemoryError(), faults.make_resource_exhausted("p")):
        assert resource.is_resource_exhausted(exc), exc
    for exc in (ValueError("out of memory?"), OSError(28, "No space left "
                                                       "on device"),
                RuntimeError("shape mismatch"), KeyError("x")):
        assert not resource.is_resource_exhausted(exc), exc
        assert not jresource.is_resource_exhausted(OSError(28, "x"))


def test_guard_passes_other_errors_through_untouched():
    err = ValueError("not an allocation")
    with pytest.raises(ValueError) as ei:
        with resource.oom_guard("train_step", "f32[3]"):
            raise err
    assert ei.value is err
    with pytest.raises(OSError) as ei:
        with resource.oom_guard("train_step", lambda: 1 / 0):
            raise OSError(28, "No space left on device")
    assert ei.value.errno == 28
    assert resource.render_shapes(torch.zeros(3, dtype=torch.float32),
                                  torch.zeros((28, 5), dtype=torch.uint8),
                                  None, np.zeros(2)) == \
        "f32[3], u8[28,5], f64[2]"


def test_memwatch_key_is_inert_and_sample_empty_without_a_card():
    # since the span hooks came the key is read (it arms the sample at
    # every span exit); sample() serves the diagnosis either way
    from lightgbm_tpu_torch.config import INERT, Config
    from lightgbm_tpu_torch.obs import memwatch
    assert "memwatch" not in INERT
    assert Config({"memwatch": "true"})["memwatch"] is True
    assert memwatch.sample(device=CPU) == {}
