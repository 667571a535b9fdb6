"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a GPU raises: the port
    never falls back to the CPU silently; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter or buffer (None if it has none)."""
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None
