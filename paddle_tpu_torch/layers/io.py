"""IO layers (counterpart of paddle_tpu/layers/io.py): ``data`` declares a
feed slot."""

from __future__ import annotations

from typing import Sequence

from ..core.framework import Variable, default_main_program
from ..core.proto import VarType

__all__ = ["data"]


def data(name: str, shape: Sequence[int], append_batch_size: bool = True,
         dtype="float32", lod_level: int = 0,
         type: VarType = VarType.LOD_TENSOR,
         stop_gradient: bool = True) -> Variable:
    """Declare an input variable; with append_batch_size a leading -1
    batch dim is added."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return default_main_program().current_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level, type=type,
        stop_gradient=stop_gradient)
