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
cross-validates.  ``Dataset`` takes numpy, scipy sparse and pandas
inputs and bundles exclusive sparse features (EFB) by default; the
growers run over the bundled columns, and ``feature_screen_ratio``
screens the lowest-gain columns out of rounds.  ``train_delta``
continues a model on fresh data with the train/serve skew check.  The
server (``serve/``) is a replica fleet with admission control, hot
reload, a health watchdog, a guarded canary lifecycle, drift monitoring
and ``/metrics``.  ``LGBMRegressor``, ``LGBMClassifier`` and
``LGBMRanker`` are the scikit-learn estimators over ``train`` and
``predict`` (``sklearn.py``), with ``device`` among their parameters so
that ``GridSearchCV``'s clones keep it.  ``plot_importance``,
``plot_metric`` and ``plot_tree`` draw a model with matplotlib, and are
exported only where matplotlib imports (``plotting.py``).  A data file
may be loaded in two rounds (``use_two_round_loading``: binned from a
row sample without holding the float matrix, ``io/streaming.py``), and
``bad_data_policy=quarantine`` skips malformed rows into
``<data>.quarantine`` under an error budget (``io/guard.py``).  A run
records itself: ``events_file`` writes one JSONL record a round,
``trace_events_file`` the span trees of rounds and requests as Chrome
trace-event JSON, ``metrics_port`` serves ``/metrics`` while training
(``obs/``), and ``python -m lightgbm_tpu_torch obs-report`` summarises
them.  Entry points run on the first CUDA card unless the caller passes
``device="cpu"``.
"""

from .config import Config
from .io import BinMapper, BinnedDataset, Metadata
from . import obs
from .basic import Booster, Dataset
from .callback import (early_stopping, log_telemetry, print_evaluation,
                       record_evaluation, reset_parameter)
from . import serve
from .engine import CVBooster, cv, train, train_delta
from .serve.forest import CompiledForest
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

try:
    import matplotlib  # noqa: F401
    from .plotting import plot_importance, plot_metric, plot_tree
    _PLOTTING = ["plot_importance", "plot_metric", "plot_tree"]
except ImportError:  # matplotlib not installed
    _PLOTTING = []

__version__ = "0.4.0"

__all__ = ["Booster", "CVBooster", "CompiledForest", "Config", "Dataset",
           "LGBMClassifier", "LGBMModel", "LGBMRanker", "LGBMRegressor",
           "LightGBMError", "__version__", "cv", "early_stopping",
           "log_telemetry", "obs", "print_evaluation",
           "record_evaluation", "reset_parameter", "serve", "train",
           "train_delta"] + _PLOTTING
