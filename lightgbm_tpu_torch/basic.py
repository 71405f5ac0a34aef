"""``Booster``: a loaded model and its predict front door.

Port of the model-file and predict half of the JAX package's basic.py
``Booster``.  ``predict`` bins rows on the host in f64 and walks them
through the forest-walk kernel (``serve/forest.py`` ``CompiledForest``),
so on a card every prediction runs the kernel.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .config import Config
from .device import DeviceLike, resolve_device
from .models.gbdt import GBDT


class Booster:
    """A loaded model: ``Booster(model_file=...)`` or
    ``Booster(model_str=...)``, on ``device`` (default ``cuda``; pass
    ``"cpu"`` for the plain PyTorch versions on the host)."""

    def __init__(self, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, params=None,
                 device: DeviceLike = None):
        if (model_file is None) == (model_str is None):
            raise TypeError("pass exactly one of model_file or model_str")
        self.device = resolve_device(device)
        self.config = Config({**dict(params or {}), "task": "predict"})
        if model_file is not None:
            with open(model_file) as fh:
                model_str = fh.read()
        self._booster = GBDT.from_string(model_str)
        self._forest = None          # (num_iteration, CompiledForest)

    def num_trees(self) -> int:
        return self._booster.num_trees()

    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._booster.save_model_to_string(num_iteration)

    def save_model(self, filename: str, num_iteration: int = -1) -> "Booster":
        """Write the model text atomically (tmp file + replace), so a
        failed save keeps the previous file."""
        tmp = f"{filename}.tmp{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        os.replace(tmp, filename)
        return self

    def compile(self, num_iteration: int = -1, buckets=None):
        """Freeze the model into a ``CompiledForest`` on this booster's
        device (the artifact ``predict`` and the server use)."""
        from .serve.forest import CompiledForest
        cf = CompiledForest.from_booster(
            self, device=self.device, num_iteration=num_iteration,
            buckets=buckets or list(self.config.predict_buckets) or None)
        self._forest = (int(num_iteration), cf)
        return cf

    def _compiled(self, num_iteration: int):
        if self._forest is None or self._forest[0] != int(num_iteration):
            self.compile(num_iteration)
        return self._forest[1]

    def predict(self, data, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        """``[N]`` for one class, ``[N, K]`` for multiclass: host f64
        binning, the binned forest-walk kernel, then the objective's
        transform in f64 unless ``raw_score``."""
        X = np.asarray(data, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        b = self._booster
        if b.num_trees() == 0:
            raw = np.zeros((b.num_class, X.shape[0]), np.float64)
        else:
            raw = self._compiled(num_iteration).raw_scores(X)
        out = raw if raw_score else np.asarray(
            b.objective.convert_output(raw))
        return out[0] if out.shape[0] == 1 else out.T
