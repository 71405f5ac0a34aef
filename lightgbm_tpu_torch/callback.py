"""Training callbacks of ``train`` and ``cv``.

The port's copy of the JAX package's callback.py (reference
python-package/lightgbm/callback.py): a callback receives a
``CallbackEnv`` before or after every round; ``before_iteration`` puts
it before the round and ``order`` sorts each group (reset_parameter 10
before; print_evaluation 10, record_evaluation 20, log_telemetry 25,
early_stopping 30 after, so the stopped round's values are recorded).
Early stopping unwinds the loop through ``EarlyStopException``.
``log_telemetry`` feeds each round's metric values into the event
stream (``obs/events.py``).
``early_stopping`` reads each evaluation entry by position, as the
reference does, so that it also takes ``cv``'s five-field entries (the
JAX package's unpacks four fields and raises on them).
"""

from __future__ import annotations

import collections

from .utils import log


class EarlyStopException(Exception):
    """Raised to stop training; ``best_iteration`` is 0-based."""

    def __init__(self, best_iteration):
        super().__init__()
        self.best_iteration = best_iteration


CallbackEnv = collections.namedtuple(
    "LightGBMCallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _format_eval_result(value, show_stdv=True):
    """(data, metric, value, bigger is better[, stdv]) -> log text."""
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        if show_stdv:
            return f"{value[0]}'s {value[1]}: {value[2]:g} + {value[4]:g}"
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    raise ValueError("Wrong metric value")


def print_evaluation(period=1, show_stdv=True):
    """Log the evaluation results every ``period`` rounds."""
    def callback(env: CallbackEnv):
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_format_eval_result(x, show_stdv)
                               for x in env.evaluation_result_list)
            log.info("[%d]\t%s", env.iteration + 1, result)
    callback.order = 10
    return callback


def record_evaluation(eval_result):
    """Record the evaluation history into the dict ``eval_result``:
    ``{data name: {metric name: [value of each round]}}``."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result has to be a dictionary")
    eval_result.clear()

    def callback(env: CallbackEnv):
        for data_name, eval_name, result, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, []).append(result)
    callback.order = 20
    return callback


def log_telemetry(recorder=None):
    """Feed each round's metric values into the event stream
    (``obs/events.py``).  With ``recorder=None`` the callback takes the
    recorder attached to the booster (``train``'s ``events_file``);
    an ``obs.EventRecorder`` pins one.  Runs after record_evaluation and
    before early_stopping, so the stopped round's values are kept."""
    def callback(env: CallbackEnv):
        rec = recorder
        if rec is None:
            inner = getattr(env.model, "_booster", None)
            rec = getattr(inner, "_telemetry", None)
        if rec is None or not env.evaluation_result_list:
            return
        ev = {}
        for item in env.evaluation_result_list:
            data_name, eval_name, value = item[0], item[1], item[2]
            ev.setdefault(data_name, {})[eval_name] = float(value)
        rec.note(env.iteration, eval=ev)
    callback.order = 25
    return callback


_UNRESETTABLE = frozenset({"num_class", "boosting_type", "metric"})


def _schedule_value(key, schedule, step, total):
    """One reset_parameter schedule at round offset ``step``: a list is
    indexed (and must cover every round), anything else is called."""
    if isinstance(schedule, list):
        if len(schedule) != total:
            raise ValueError(
                f"reset_parameter: list for {key!r} has {len(schedule)} "
                f"entries but training runs {total} rounds")
        return schedule[step]
    return schedule(step)


def reset_parameter(**kwargs):
    """Reset parameters before each round: a value is a list (one entry a
    round) or a function of the round's offset from the first, e.g.
    ``reset_parameter(learning_rate=lambda i: 0.1 * 0.99 ** i)``.  Only
    a real change reaches ``Booster.reset_parameter``."""
    bad = _UNRESETTABLE.intersection(kwargs)
    if bad:
        raise RuntimeError(
            f"cannot reset {sorted(bad)[0]} during training")

    def callback(env: CallbackEnv):
        step = env.iteration - env.begin_iteration
        total = env.end_iteration - env.begin_iteration
        changed = {}
        for key, schedule in kwargs.items():
            value = _schedule_value(key, schedule, step, total)
            if env.params.get(key) != value:
                changed[key] = value
        if changed:
            env.model.reset_parameter(changed)
            env.params.update(changed)
    callback.before_iteration = True
    callback.order = 10
    return callback


def early_stopping(stopping_rounds, verbose=True):
    """Stop when no (data set, metric) pair of the evaluation list has
    improved for ``stopping_rounds`` rounds; sets the model's
    ``best_iteration`` (1-based) and raises ``EarlyStopException``."""
    best_score = []
    best_iter = []
    best_score_list = []
    cmp_op = []

    def init(env: CallbackEnv):
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if verbose:
            log.info("Train until valid scores didn't improve in %d rounds.",
                     stopping_rounds)
        # by position: ``cv``'s entries carry a fifth field, the stdv
        for ret in env.evaluation_result_list:
            best_iter.append(0)
            best_score_list.append(None)
            if ret[3]:
                best_score.append(float("-inf"))
                cmp_op.append(lambda a, b: a > b)
            else:
                best_score.append(float("inf"))
                cmp_op.append(lambda a, b: a < b)

    def callback(env: CallbackEnv):
        if not cmp_op:
            init(env)
        for i, ret in enumerate(env.evaluation_result_list):
            score = ret[2]
            if cmp_op[i](score, best_score[i]):
                best_score[i] = score
                best_iter[i] = env.iteration
                best_score_list[i] = env.evaluation_result_list
            elif env.iteration - best_iter[i] >= stopping_rounds:
                if env.model is not None:
                    env.model.best_iteration = best_iter[i] + 1
                if verbose:
                    log.info("Early stopping, best iteration is:\n[%d]\t%s",
                             best_iter[i] + 1,
                             "\t".join(_format_eval_result(x)
                                       for x in best_score_list[i]))
                raise EarlyStopException(best_iter[i])
    callback.order = 30
    return callback
