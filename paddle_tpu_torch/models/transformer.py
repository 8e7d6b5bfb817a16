"""Pieces of paddle_tpu/models/transformer.py the serving decoder needs.

Only the sinusoid position table for now: the JAX serving module imports
it from the JAX model file, and the port keeps its own copy so that it
imports nothing of ``paddle_tpu``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_sinusoid_table"]


def _sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * dim / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table
