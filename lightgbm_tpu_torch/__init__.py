"""PyTorch/CUDA port of lightgbm_tpu.

The serving path: model text -> frozen forest -> the hand-written
forest-walk CUDA kernel (``csrc/forest_walk.cu``) -> micro-batcher and
HTTP server.  Entry points run on the first CUDA card unless the caller
passes ``device="cpu"``.
"""

from .basic import Booster
from .serve.forest import CompiledForest
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "CompiledForest", "LightGBMError", "__version__"]
