"""``train`` and ``cv``: the boosting loops of the Python API.

Port of the JAX package's engine.py.  ``train`` builds a Booster on
``device`` (default ``cuda``), continues from ``init_model`` (a model
file or a Booster: its trees first, the training scores from its raw
predictions), attaches the valid sets, and runs one ``update()`` a round
between the callbacks (callback.py): ``reset_parameter`` before the
round (``learning_rates``), then ``print_evaluation`` (``verbose_eval``),
``record_evaluation`` (``evals_result``) and ``early_stopping``
(``early_stopping_rounds``), which stops the loop and sets the Booster's
``best_iteration``.  ``cv`` trains one Booster a fold (``CVBooster``) on
row subsets that share the full Dataset's mappers and aggregates their
valid metrics into means and standard deviations.

Crash safety, as in the JAX ``train``: ``snapshot_dir`` with
``snapshot_freq`` (alias ``save_period``) writes a snapshot every K
rounds (``snapshot.py``; the newest ``snapshot_keep`` are kept), and a
run that finds a valid snapshot there resumes from it, through the
ranks' consensus (``coordinated_resume``) under a distributed learner;
``sink_error_policy`` sets the sinks' write-failure policy
(``utils/diskguard.py``).  Telemetry as in the JAX ``train``:
``events_file`` streams one record a round, ``trace_events_file``
exports the rounds' span trees, ``metrics_port`` serves ``/metrics``
while the run lasts (``_RunTelemetry``).  The JAX compile cache has no
counterpart (``compile_cache_dir`` is ignored with one warning).
``train_delta``
continues a base model on fresh data and warns when the fresh rows
drifted from the base model's training fingerprint.
"""

from __future__ import annotations

import collections
import copy
import sys
from typing import List

import numpy as np

from . import callback, obs
from .basic import Booster, Dataset
from .device import DeviceLike
from .utils import log

_ROUND_ALIASES = ("num_boost_round", "num_iterations", "num_iteration",
                  "num_tree", "num_trees", "num_round", "num_rounds")


def _pop_rounds(params: dict, num_boost_round: int) -> int:
    """A round count in ``params`` (any alias) overrides the argument."""
    for alias in _ROUND_ALIASES:
        if alias in params:
            return int(params.pop(alias))
    return num_boost_round


def _snapshot_settings(p: dict):
    """(``snapshot_dir`` or None, ``snapshot_freq``, ``snapshot_keep``)
    from alias-resolved params (the CLI's strings too)."""
    directory = str(p.get("snapshot_dir") or "") or None
    try:
        freq = int(p.get("snapshot_freq", 0) or 0)
    except (TypeError, ValueError):
        raise ValueError(f"snapshot_freq={p['snapshot_freq']!r} "
                         "is not an integer")
    try:
        keep = int(p.get("snapshot_keep", 3) or 0)
    except (TypeError, ValueError):
        keep = 3
    if freq > 0 and not directory:
        log.warning("snapshot_freq=%d but no snapshot_dir given; "
                    "snapshots are DISABLED", freq)
    return directory, freq, keep


def _find_resume(snapshot_dir):
    """The snapshot to resume from: the ranks' consensus under a group
    of more than one rank, else the newest valid file."""
    from .parallel.multihost import process_rank_world
    from .snapshot import coordinated_resume, load_latest_snapshot
    if process_rank_world()[1] > 1:
        return coordinated_resume(snapshot_dir)
    return load_latest_snapshot(snapshot_dir)


def _flush_stdio() -> None:
    sys.stdout.flush()
    sys.stderr.flush()


def _order(cb) -> int:
    return getattr(cb, "order", 0)


def _split_callbacks(cbs):
    """(before the round, after it), each sorted by ``order``."""
    before = [cb for cb in cbs if getattr(cb, "before_iteration", False)]
    after = [cb for cb in cbs if cb not in before]
    return sorted(before, key=_order), sorted(after, key=_order)


class _RunTelemetry:
    """A ``train`` run's telemetry (the JAX ``train``'s): the causal
    tracer, the compile ledger's sink, ``devprof`` and ``memwatch``
    configured at the start from the run's keys (a run without them
    disarms each; the env variables win), the event recorder on the
    booster (``events_file``) and the ``/metrics`` listener
    (``metrics_port``), shut down on every exit of the run, an
    exception's too, where the span trees are exported and a device
    trace window still open is closed."""

    def __init__(self, params: dict, events_file=None):
        self.params = params
        self.events_file = events_file or params.get("events_file") or None
        self.recorder = None
        self.metrics = None
        self._gbdt = None
        self._watchdog = None

    def __enter__(self) -> "_RunTelemetry":
        p = self.params
        obs.TRACER.configure(p.get("trace_events_file") or None)
        obs.compile_ledger.configure(p.get("compile_ledger_file") or None)
        obs.devprof.configure(p.get("devprof"))
        obs.memwatch.configure(p.get("memwatch"))
        return self

    def record(self, booster: Booster) -> None:
        """Hold the run's booster (its trace window closes with the run)
        and attach the event recorder to it, when asked for."""
        self._gbdt = booster._booster
        if not self.events_file:
            return
        flush_every = int(self.params.get("events_flush_every", 1) or 1)
        self.recorder = obs.EventRecorder(str(self.events_file),
                                          flush_every=flush_every)
        self._gbdt.set_event_recorder(self.recorder)

    def start(self, watchdog) -> None:
        """Start the listener after the set-up that can raise, and hand
        the recorder to the collective watchdog, whose hard abort skips
        every finally."""
        from .obs.metrics_server import maybe_start
        self.metrics = maybe_start(self.params)
        if watchdog is not None and self.recorder is not None:
            self._watchdog = watchdog
            watchdog.register_flush(self.recorder.close)

    def __exit__(self, *exc) -> None:
        if self._gbdt is not None:
            # a trace window the run ended inside is written now
            self._gbdt.close_trace()
        if self.recorder is not None:
            self.recorder.close()
            self._gbdt.set_event_recorder(None)
        if self.metrics is not None:
            self.metrics.stop()
        if self._watchdog is not None:
            self._watchdog.unregister_flush(self.recorder.close)
        obs.TRACER.maybe_export()


def train(params, train_set: Dataset, num_boost_round: int = 100,
          valid_sets=None, valid_names=None, fobj=None, feval=None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds=None, evals_result=None, verbose_eval=True,
          learning_rates=None, callbacks=None,
          device: DeviceLike = None, events_file=None) -> Booster:
    """Train a GBDT; returns the Booster.

    ``valid_sets`` may include ``train_set`` itself (its metrics are then
    reported under its name in ``valid_names``).  A round count in
    ``params`` (``num_iterations`` and its aliases) overrides
    ``num_boost_round``.  ``fobj(preds, train_set) -> (grad, hess)`` and
    ``feval(preds, dataset) -> (name, value, bigger is better)`` are a
    custom objective and metric.  ``init_model`` (a model file's path or
    a Booster) continues its model: the rounds run from its iteration
    count on, and a constructed ``train_set`` must keep its raw data
    (``free_raw_data=False``).  ``verbose_eval`` is a bool or a logging
    period; ``learning_rates`` a list (one a round) or a function of the
    round; ``callbacks`` more callables of ``callback.CallbackEnv``.
    Training stops early when a tree cannot split.

    With ``snapshot_dir`` the run resumes from the newest valid snapshot
    there (it takes precedence over ``init_model``), restoring the
    booster, ``evals_result`` and the registry, and writes one every
    ``snapshot_freq`` rounds.  The early-stopping counter restarts at
    the resume point.

    Telemetry, as in the JAX ``train``: ``events_file`` (the argument
    or the key) streams one JSONL record a round (``obs/events.py``,
    fed by ``callback.log_telemetry``), ``trace_events_file`` exports
    the rounds' span trees as Chrome trace-event JSON when the run ends
    (``LIGHTGBM_TPU_TRACE_EVENTS`` wins), and ``metrics_port``
    (``LIGHTGBM_TPU_METRICS_PORT`` wins) serves ``GET /metrics`` while
    the run lasts.  All three shut down on every exit of ``train``."""
    params = dict(params or {})
    # each run's sink policy holds, and sinks an earlier run's full disk
    # disabled are re-armed (this run may write elsewhere)
    from .config import apply_aliases
    from .utils import diskguard
    aliased = apply_aliases(dict(params))
    with _RunTelemetry(aliased, events_file) as telemetry:
        diskguard.set_default_policy(aliased.get("sink_error_policy") or None)
        diskguard.reset_disabled()
        snapshot_dir, snapshot_freq, snapshot_keep = \
            _snapshot_settings(aliased)
        resume_state = None
        if snapshot_dir:
            found = _find_resume(snapshot_dir)
            if found is not None:
                resume_path, resume_state = found
                if init_model is not None:
                    log.warning("snapshot %s takes precedence over "
                                "init_model for resume", resume_path)
                    init_model = None
                log.info("Resuming from snapshot %s (%d rounds done)",
                         resume_path, int(resume_state.get("rounds_done", 0)))
        if fobj is not None:
            params["objective"] = "none"
        num_boost_round = _pop_rounds(params, num_boost_round)

        predictor = None
        if isinstance(init_model, str):
            predictor = Booster(model_file=init_model, device=device)
        elif isinstance(init_model, Booster):
            predictor = init_model._to_predictor()
        init_iteration = 0
        if predictor is not None:
            # every earlier round, those the predictor itself continued from
            init_iteration = len(predictor._booster.models) // max(
                predictor._booster.num_class, 1)

        if not isinstance(train_set, Dataset):
            raise TypeError("Training only accepts Dataset object")
        # the predictor first: on a constructed Dataset it unbinds it, and
        # the params then reach the new binning (the JAX package's order of
        # effects)
        train_set._set_predictor(predictor)._update_params(params) \
            .set_feature_name(feature_name) \
            .set_categorical_feature(categorical_feature)
        booster = Booster(params=params, train_set=train_set, device=device)
        if predictor is not None:
            gb = booster._booster
            gb.models = list(predictor._booster.models) + gb.models
            gb.num_init_iteration = init_iteration
            gb.iter_ = init_iteration

        with_train, train_name = False, "training"
        valid = []
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        for i, vs in enumerate(valid_sets or []):
            if vs is train_set:
                with_train = True
                if valid_names is not None:
                    train_name = valid_names[i]
                continue
            if not isinstance(vs, Dataset):
                raise TypeError("Validation data should be Dataset instance")
            valid.append((vs._update_params(params),
                          valid_names[i] if valid_names is not None
                          else f"valid_{i}"))
        booster.set_train_data_name(train_name)
        for vs, name in valid:
            booster.add_valid(vs, name)

        # the resume state after the valid sets, so their saved scores land
        # on their buffers
        resume_done = 0
        if resume_state is not None:
            from .snapshot import restore_booster_state
            resume_done = restore_booster_state(booster, resume_state)
            init_iteration = booster._booster.num_init_iteration
            if early_stopping_rounds is not None:
                log.warning("resuming with early_stopping_rounds=%d: the "
                            "early-stopping counter restarts at iteration %d "
                            "(its pre-crash best-score baseline is not part "
                            "of the snapshot)", early_stopping_rounds,
                            init_iteration + resume_done)
            if resume_done >= num_boost_round:
                log.warning("snapshot already holds %d rounds >= "
                            "num_boost_round=%d; nothing left to train",
                            resume_done, num_boost_round)

        telemetry.record(booster)

        cbs = set(callbacks or [])
        if telemetry.recorder is not None:
            cbs.add(callback.log_telemetry())
        if verbose_eval is True:
            cbs.add(callback.print_evaluation())
        elif isinstance(verbose_eval, int) and verbose_eval is not False:
            cbs.add(callback.print_evaluation(verbose_eval))
        if early_stopping_rounds is not None:
            cbs.add(callback.early_stopping(early_stopping_rounds,
                                            verbose=bool(verbose_eval)))
        if learning_rates is not None:
            cbs.add(callback.reset_parameter(learning_rate=learning_rates))
        if evals_result is not None:
            cbs.add(callback.record_evaluation(evals_result))
        before, after = _split_callbacks(cbs)
        # the history restored after record_evaluation cleared the dict: the
        # resumed run's evals_result continues the interrupted one's
        if resume_state is not None and evals_result is not None \
                and resume_state.get("evals_result"):
            evals_result.update(copy.deepcopy(resume_state["evals_result"]))

        # a watchdog's hard abort (parallel/watchdog.py) skips every finally:
        # it flushes the log streams first
        from .parallel.watchdog import active_watchdog
        watchdog = active_watchdog()
        if watchdog is not None:
            watchdog.register_flush(_flush_stdio)
        telemetry.start(watchdog)
        try:
            end = init_iteration + num_boost_round
            for i in range(init_iteration + resume_done, end):
                for cb in before:
                    cb(callback.CallbackEnv(model=booster, params=params,
                                            iteration=i,
                                            begin_iteration=init_iteration,
                                            end_iteration=end,
                                            evaluation_result_list=None))
                finished = booster.update(fobj=fobj)
                results = booster.eval_train(feval) if with_train else []
                if valid:
                    results += booster.eval_valid(feval)
                try:
                    for cb in after:
                        cb(callback.CallbackEnv(
                            model=booster, params=params, iteration=i,
                            begin_iteration=init_iteration,
                            end_iteration=end,
                            evaluation_result_list=results))
                except callback.EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    break
                if snapshot_dir and snapshot_freq > 0 \
                        and (i + 1 - init_iteration) % snapshot_freq == 0:
                    from .snapshot import save_snapshot
                    save_snapshot(snapshot_dir, booster,
                                  rounds_done=i + 1 - init_iteration,
                                  evals_result=evals_result,
                                  keep=snapshot_keep)
                if finished:
                    break
        finally:
            if watchdog is not None:
                watchdog.unregister_flush(_flush_stdio)
        return booster


def _base_fingerprint(base_model):
    """The base model's training-data fingerprint, from a Booster or
    parsed out of a model file's tail; None when it has none (the skew
    check then abstains)."""
    from .obs.drift import parse_model_fingerprint
    try:
        if isinstance(base_model, str):
            with open(base_model) as fh:
                return parse_model_fingerprint(fh.read())
        inner = getattr(base_model, "_booster", base_model)
        return getattr(inner, "data_fingerprint", None)
    except Exception:
        # a garbled section raises its named error on train()'s load;
        # the advisory check never preempts that
        return None


def train_delta(base_model, fresh_data, num_trees=100, params=None,
                **kwargs):
    """Warm-start retrain (the JAX package's ``train_delta``): boost
    ``num_trees`` rounds on ``fresh_data`` on top of ``base_model`` (a
    Booster or a model file) through ``train(init_model=)``; the base
    trees are carried over untouched and the delta model carries the
    fresh data's fingerprint.  ``kwargs`` go to :func:`train`
    (``device`` among them).

    Train/serve skew check: the fresh data's raw rows are re-binned
    under the base model's fingerprint edges (``obs/drift.py``
    ``compare_to_data``, the serve collector's comparison).  Features
    whose PSI passes ``lifecycle_drift_threshold`` (default 0.25) become
    one named warning and a ``drift_skew_warnings_total`` count, never a
    refusal."""
    base_fp = _base_fingerprint(base_model)
    raw = getattr(fresh_data, "data", None)   # before free_raw_data
    raw = None if isinstance(raw, str) else raw
    booster = train(dict(params or {}), fresh_data,
                    num_boost_round=num_trees, init_model=base_model,
                    **kwargs)
    cmp = None
    threshold = float((params or {}).get("lifecycle_drift_threshold",
                                         0.25) or 0.25)
    top_k = int((params or {}).get("drift_top_k", 5) or 5)
    if base_fp is not None and raw is not None:
        from .obs.drift import compare_to_data
        try:
            cmp = compare_to_data(base_fp, raw, top_k=top_k)
        except Exception:
            cmp = None    # a ragged or exotic raw payload abstains
    if cmp is not None:
        offenders = [f for f in cmp["features"] if f["psi"] > threshold]
        if offenders:
            obs.inc("drift_skew_warnings_total")
            log.warning(
                "train_delta: fresh data drifted from the base model's "
                "training distribution (train/serve skew): %s "
                "(PSI threshold %g; rows %d -> %d)",
                ", ".join(f"{f['feature']} psi={f['psi']:g}"
                          for f in offenders),
                threshold, cmp["expected_rows"], cmp["actual_rows"])
    return booster


class CVBooster:
    """The fold Boosters of ``cv``: a method called on it is called on
    each fold and returns the list of their results."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(full_data: Dataset, data_splitter, nfold, params, seed,
                  fpreproc=None, stratified=False, shuffle=True,
                  device: DeviceLike = None) -> CVBooster:
    """One Booster a fold, each with its valid rows attached as
    ``valid``.  The folds are ``data_splitter.split`` of the row indices,
    or from ``np.random.RandomState(seed)``: stratified by label class
    (each class's rows shuffled, then dealt round-robin), or a
    permutation dealt ``randidx[k::nfold]``; the same folds as the JAX
    package's, index for index."""
    full_data.construct()
    num_data = full_data.num_data()
    if data_splitter is not None:
        if not hasattr(data_splitter, "split"):
            raise AttributeError("data_splitter has no method 'split'")
        folds = data_splitter.split(np.arange(num_data))
    elif stratified:
        label = np.asarray(full_data.get_label())
        classes, y = np.unique(label, return_inverse=True)
        rng = np.random.RandomState(seed)
        fold_id = np.zeros(num_data, np.int64)
        for c in range(len(classes)):
            idx = np.where(y == c)[0]
            if shuffle:
                rng.shuffle(idx)
            fold_id[idx] = np.arange(len(idx)) % nfold
        folds = [(np.where(fold_id != k)[0], np.where(fold_id == k)[0])
                 for k in range(nfold)]
    else:
        if shuffle:
            randidx = np.random.RandomState(seed).permutation(num_data)
        else:
            randidx = np.arange(num_data)
        test_id = [randidx[i::nfold] for i in range(nfold)]
        folds = [(np.setdiff1d(randidx, test_id[k], assume_unique=False),
                  test_id[k]) for k in range(nfold)]

    ret = CVBooster()
    for train_idx, test_idx in folds:
        train_subset = full_data.subset(np.sort(train_idx))
        valid_subset = full_data.subset(np.sort(test_idx))
        if fpreproc is not None:
            train_subset, valid_subset, tparam = fpreproc(
                train_subset, valid_subset, params.copy())
        else:
            tparam = params
        fold = Booster(params=tparam, train_set=train_subset, device=device)
        fold.add_valid(valid_subset, "valid")
        ret.append(fold)
    return ret


def _agg_cv_result(raw_results):
    """[("cv_agg", "<data> <metric>", mean, bigger is better, stdv)] over
    the folds' evaluation lists."""
    cvmap = collections.OrderedDict()
    metric_type = {}
    for one_result in raw_results:
        for one_line in one_result:
            key = f"{one_line[0]} {one_line[1]}"
            metric_type[key] = one_line[3]
            cvmap.setdefault(key, []).append(one_line[2])
    return [("cv_agg", k, float(np.mean(v)), metric_type[k],
             float(np.std(v))) for k, v in cvmap.items()]


def cv(params, train_set: Dataset, num_boost_round: int = 10,
       data_splitter=None, nfold: int = 5, stratified: bool = False,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, feature_name="auto", categorical_feature="auto",
       early_stopping_rounds=None, fpreproc=None, verbose_eval=None,
       show_stdv: bool = True, seed: int = 0, callbacks=None,
       device: DeviceLike = None) -> dict:
    """Cross-validation: ``{"<data> <metric>-mean": [one a round],
    "...-stdv": [...]}`` over ``nfold`` folds (``_make_n_folds``), cut
    to ``best_iteration`` rounds when ``early_stopping_rounds`` stops
    it.  ``init_model`` is accepted and unused, as in the JAX package."""
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = dict(params or {})
    if fobj is not None:
        params["objective"] = "none"
    num_boost_round = _pop_rounds(params, num_boost_round)
    if metrics is not None:
        params["metric"] = metrics
    train_set._update_params(params) \
        .set_feature_name(feature_name) \
        .set_categorical_feature(categorical_feature)

    results = collections.defaultdict(list)
    cvfolds = _make_n_folds(train_set, data_splitter, nfold, params, seed,
                            fpreproc=fpreproc, stratified=stratified,
                            shuffle=shuffle, device=device)

    cbs = set(callbacks or [])
    if early_stopping_rounds is not None:
        cbs.add(callback.early_stopping(early_stopping_rounds,
                                        verbose=False))
    if verbose_eval is True:
        cbs.add(callback.print_evaluation(show_stdv=show_stdv))
    elif isinstance(verbose_eval, int):
        cbs.add(callback.print_evaluation(verbose_eval, show_stdv=show_stdv))
    before, after = _split_callbacks(cbs)

    for i in range(num_boost_round):
        for cb in before:
            cb(callback.CallbackEnv(model=cvfolds, params=params,
                                    iteration=i, begin_iteration=0,
                                    end_iteration=num_boost_round,
                                    evaluation_result_list=None))
        for fold in cvfolds.boosters:
            fold.update(fobj=fobj)
        res = _agg_cv_result([fold.eval_valid(feval)
                              for fold in cvfolds.boosters])
        for _, key, mean, _, std in res:
            results[key + "-mean"].append(mean)
            results[key + "-stdv"].append(std)
        try:
            for cb in after:
                cb(callback.CallbackEnv(model=cvfolds, params=params,
                                        iteration=i, begin_iteration=0,
                                        end_iteration=num_boost_round,
                                        evaluation_result_list=res))
        except callback.EarlyStopException as e:
            cvfolds.best_iteration = e.best_iteration + 1
            for k in results:
                results[k] = results[k][:cvfolds.best_iteration]
            break
    return dict(results)
