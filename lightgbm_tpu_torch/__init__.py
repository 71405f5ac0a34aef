"""PyTorch/CUDA port of lightgbm_tpu.

Two paths.  Serving: model text -> frozen forest -> the hand-written
forest-walk CUDA kernel (``csrc/forest_walk.cu``; constant or affine
leaves, f32 or bf16 leaf tables) -> micro-batcher and HTTP server.
Training (serial; every objective of the JAX package, a custom ``fobj``
too): ``train(params, Dataset(X or a data file, y))`` -> objective
gradients -> the grower ``serial_grow`` selects -> (``linear_tree``: the
per-leaf affine fit, ``models/linear.py``) -> score update.  ``ordered``
(default) and ``cached`` run the hand-written leaf-histogram kernel
(``csrc/leaf_hist.cu``); ``fused`` and the ``nocache`` grower of the
``hist_cache`` degrade step run the hand-written full-pass kernels of
``csrc/children_hist.cu``.  ``boosting_type`` is ``gbdt``, ``goss`` or
``dart``, with bagging and ``feature_fraction`` drawn as the JAX package
draws them.  ``train`` continues from ``init_model``,
stops early, takes callbacks and per-round learning rates; ``cv``
cross-validates.  Entry points run on the first CUDA card unless the
caller passes ``device="cpu"``.
"""

from .basic import Booster, Dataset
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .engine import CVBooster, cv, train
from .serve.forest import CompiledForest
from .utils.log import LightGBMError

__version__ = "0.4.0"

__all__ = ["Booster", "CVBooster", "CompiledForest", "Dataset",
           "LightGBMError", "__version__", "cv", "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "train"]
