"""Device places (counterpart of paddle_tpu/core/place.py).

A Place names the device an Executor runs on: ``CUDAPlace(i)`` is card i
(resolving it raises without a card), ``CPUPlace()`` the host, where every
kernel wrapper takes its plain PyTorch version.  The JAX package's
``TPUPlace`` has no counterpart.
"""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["CPUPlace", "CUDAPlace", "Place"]


class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    def torch_device(self) -> torch.device:
        resolve_device(None)  # raises NoCudaDeviceError without a card
        return torch.device("cuda", self.device_id)
