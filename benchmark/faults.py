"""The faults a cell's correctness check has to catch, planted in the
program under the runners (``make_trainer`` / ``make_scorer``).  Used by
``calibrate.py`` on the card and by ``tests/test_correctness.py`` on the
CPU; the benchmark's own runs never plant one.

Training: ``stale_step`` (a round that returns with the booster
unchanged), ``half_batch`` (the odd rows' gradients left out and the
even rows' doubled, the mean taken over the rest), ``altered_answer``
(the grown tree's first leaf value altered where it is produced).
Scoring: ``stale_step`` (a call that returns the previous call's
answer), ``half_batch`` (the second half of a call's rows given the
mean of the first half's scores), ``altered_answer`` (one score
altered).  One card, so no exchange between chips can be left out."""

from __future__ import annotations

import numpy as np

from .runners import train as dtrain

TRAIN = ("stale_step", "half_batch", "altered_answer")
SCORE = ("stale_step", "half_batch", "altered_answer")


def trainer(fault: str, lt):
    """A ``make_trainer`` that plants ``fault`` in the program."""

    def make(X, y, group, cfg, device, setup):
        t = dtrain.ProgramTrainer(lt, X, y, group, cfg["params"], device, setup)
        gbdt = t.booster._booster
        if fault == "stale_step":
            t.update = lambda: False
        elif fault == "half_batch":
            obj = gbdt.objective
            real = obj.gradients_with

            def half(arrays, score):
                g, h = real(arrays, score)
                g, h = g.clone(), h.clone()
                g[:, 1::2] = 0.0
                h[:, 1::2] = 0.0
                return g * 2.0, h * 2.0
            obj.gradients_with = half
        elif fault == "altered_answer":
            real_update = t.update

            def altered():
                stop = real_update()
                gbdt.models[-1].leaf_value[0] += 0.01
                return stop
            t.update = altered
        else:
            raise ValueError(fault)
        return t
    return make


class _Wrapped:
    def __init__(self, inner, fault):
        self.inner, self.fault, self.prev = inner, fault, None

    def predict(self, X):
        out = np.array(self.inner.predict(X), np.float64)
        if self.fault == "stale_step":
            prev, self.prev = self.prev, out
            return out if prev is None else prev
        if self.fault == "half_batch":
            h = len(out) // 2
            out[h:] = out[:h].mean() if h else out[h:]
        elif self.fault == "altered_answer":
            out[0] += 0.01
        return out

    def close(self):
        self.inner.close()


def scorer(fault: str, lt, setup):
    """A ``make_scorer`` that plants ``fault`` in the program."""
    from .runners import score as dscore

    def make(trees, text, device):
        return _Wrapped(dscore.ProgramScorer(lt, text, device, setup), fault)
    return make
