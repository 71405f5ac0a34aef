"""Device resolution for every entry point of the port.

The default is the first CUDA card.  The CPU is used only when the
caller names it (the tests do); with no card present and no explicit
``"cpu"``, resolution raises instead of quietly running the plain
PyTorch versions of the kernels on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .utils.log import LightGBMError

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"`` -> ``cuda:0``; ``"cpu"`` -> ``cpu``; a CUDA
    index is kept.  Raises :class:`LightGBMError` for a CUDA request on
    a host without a card, and for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise LightGBMError(
            f"device {str(dev)!r} is not supported: use 'cuda' (default) "
            f"or 'cpu'")
    if not torch.cuda.is_available():
        raise LightGBMError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise LightGBMError(
            f"device cuda:{index} does not exist "
            f"({torch.cuda.device_count()} card(s) visible)")
    return torch.device("cuda", index)
