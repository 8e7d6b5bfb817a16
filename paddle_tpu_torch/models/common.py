"""ModelSpec: what a model builder hands back to benches and tests
(counterpart of paddle_tpu/models/common.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class ModelSpec:
    name: str
    feed_names: List[str]
    loss: Any  # Variable
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # batch_size -> {feed_name: np.ndarray}; deterministic synthetic data
    synthetic_batch: Optional[Callable[[int], Dict[str, np.ndarray]]] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
