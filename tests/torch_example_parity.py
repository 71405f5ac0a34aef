"""Shared body of tests/test_torch_example_*.py: one example conf of
``examples/`` through the JAX CLI and through the port's CLI
(``device=cpu``), 3 rounds each, in a copy of the example's directory.

``run_conf`` trains with ``train.conf`` as written (the regression
conf's bagging and feature fraction too), logs each round's metrics,
then runs
``predict.conf`` on the example's test file with each model, and the
port's CLI once more on the JAX model.  (Both CLIs read the files with
their native loaders, which convert decimals to the same bits where the
library builds; where it does not, a package reads through Python's
``float``, which can differ in the last bit, so thresholds are compared
to 1e-9.  ``tests/test_torch_native_loader.py`` holds them exactly.)
The checks, with the comparisons of ``chip_smoke.py`` (which holds the
card's run against the CPU's the same way):

* ``compare_trees``: every tree structure-equal (split features,
  thresholds within 1e-9 relative, children, decision types, leaf
  counts) and leaf values within 1e-5 of the largest.  The two packages
  sum f32 gradients in different orders (XLA's reductions against
  torch's), so a split whose two best candidates' gains lie within
  ``TIE_RTOL`` of each other may go either way: such a near-tie is
  reported, its gains checked, and no tree after it is compared
  structurally (every later score depends on it).
* every round's every metric within 1e-4 (a ranking metric beyond it
  only at a near-tie of scores, ``compare_metrics``);
* the predictions of ``predict.conf`` within 1e-5 (relative and
  absolute: the files carry six significant digits): the port's CLI on
  the JAX model against the JAX CLI always, and the two packages' own
  models against each other unless a near-tie flipped a split.
"""

import numpy as np

import chip_smoke as cs
import lightgbm_tpu.cli as jax_cli
import lightgbm_tpu_torch.cli as torch_cli

ROUNDS = 3
TIE_RTOL = 1e-5
LEAF_RTOL = 1e-5
NAMES = ("torch", "jax")
MODELS = ("torch_model.txt", "jax_model.txt")
def run_conf(name: str, example: str, tmp_path_factory) -> dict:
    """Train and predict one example conf with both CLIs; returns the
    work directory, both logs' metrics and the prediction arrays."""
    work = tmp_path_factory.mktemp(name)
    conf = cs.copy_example(name, example, str(work))
    common = [f"config={conf}", f"num_trees={ROUNDS}"]
    with cs.in_dir(work):
        jlog = cs.run_main(jax_cli.main,
                           common + ["output_model=jax_model.txt",
                                     "compile_cache_dir=off"])
        tlog = cs.run_main(torch_cli.main,
                           common + ["output_model=torch_model.txt",
                                     "device=cpu"])
        cs.run_main(jax_cli.main, ["config=predict.conf",
                                   "input_model=jax_model.txt",
                                   "output_result=jax_pred.txt"])
        cs.run_main(torch_cli.main, ["config=predict.conf", "device=cpu",
                                     "input_model=torch_model.txt",
                                     "output_result=torch_pred.txt"])
        cs.run_main(torch_cli.main, ["config=predict.conf", "device=cpu",
                                     "input_model=jax_model.txt",
                                     "output_result=torch_on_jax_pred.txt"])
    return {"work": work, "conf": conf, "jax_log": jlog, "torch_log": tlog,
            "jax_metrics": cs.round_metrics(jlog),
            "torch_metrics": cs.round_metrics(tlog),
            **{k: np.loadtxt(work / f"{k}.txt", ndmin=1) for k in
               ("jax_pred", "torch_pred", "torch_on_jax_pred")}}


def compare_trees(run: dict) -> dict:
    """Structure and values of every tree of the two models, up to the
    first near-tie (``TIE_RTOL``); returns {"trees": n, "flip": None or
    where the choices differ and their gains}."""
    work = run["work"]
    trees, flip, _ = cs.compare_model_texts(
        (work / "torch_model.txt").read_text(),
        (work / "jax_model.txt").read_text(), str(work), names=NAMES,
        tie_rtol=TIE_RTOL, leaf_rtol=LEAF_RTOL)
    return {"trees": trees, "flip": flip}


def compare_metrics(run: dict) -> list:
    """Every round's every metric within 1e-4 (a ranking metric beyond
    it only at a near-tie of scores, ``cs.compare_round_metrics``).
    Returns the ranking metrics so explained."""
    return cs.compare_round_metrics(
        run["torch_metrics"], run["jax_metrics"], run["work"], run["conf"],
        str(run["work"]), MODELS, names=NAMES)[1]


def compare_predictions(run: dict, flip) -> None:
    want = run["jax_pred"]
    np.testing.assert_allclose(run["torch_on_jax_pred"], want, rtol=1e-5,
                               atol=1e-5)
    if flip is None:
        np.testing.assert_allclose(run["torch_pred"], want, rtol=1e-5,
                                   atol=1e-5)
    assert run["torch_pred"].shape == want.shape
    assert np.isfinite(run["torch_pred"]).all()
