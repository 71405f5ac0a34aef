"""C API surface (reference include/LightGBM/c_api.h, src/c_api.cpp).

- ``build_library()`` -> path to ``lib_lightgbm_tpu_torch.so``, a shared
  library built from the hand-written C shim ``c_api.c`` that exports
  every LGBM_* symbol for C and ``ctypes`` callers, the drop-in
  equivalent of the reference's ``lib_lightgbm.so``.  Its first call
  boots (or joins) a Python interpreter and binds ``impl.py``.
- ``lightgbm_tpu_torch.capi.impl`` -> the functions behind the symbols.

Training runs on the card unless the booster's parameters say
``device=cpu``; a model loaded from a file or a string takes its device
at its first predict (``LGBM_BoosterResetParameter(h, "device=cpu")``
asks for the host).
"""

from .build import build_library  # noqa: F401
from .cdef import API_NAMES, CDEF  # noqa: F401
