"""Device resolution for the port's entry points.

The port runs on the card.  ``device=None`` means CUDA, and raises when
no CUDA device is present: an entry point never drops to the CPU on its
own.  Tests and CPU tools ask for the CPU explicitly with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["NoCudaDeviceError", "resolve_device"]


class NoCudaDeviceError(RuntimeError):
    """``device=None`` asked for the card and this host has none."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raising :class:`NoCudaDeviceError` without a
    card); anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDeviceError(
                "no CUDA device: the port runs on the card — pass "
                "device='cpu' explicitly to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
