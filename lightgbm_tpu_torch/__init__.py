"""PyTorch/CUDA port of lightgbm_tpu.

Two paths.  Serving: model text -> frozen forest -> the hand-written
forest-walk CUDA kernel (``csrc/forest_walk.cu``) -> micro-batcher and
HTTP server.  Training (serial, leaf-ordered, binary): ``train(params,
Dataset(X, y))`` -> objective gradients -> ``grow_tree_ordered`` with the
hand-written leaf-histogram kernel (``csrc/leaf_hist.cu``) -> split scan
-> score update.  Entry points run on the first CUDA card unless the
caller passes ``device="cpu"``.
"""

from .basic import Booster, Dataset
from .engine import train
from .serve.forest import CompiledForest
from .utils.log import LightGBMError

__version__ = "0.2.0"

__all__ = ["Booster", "CompiledForest", "Dataset", "LightGBMError",
           "__version__", "train"]
