"""ModelSpec: what a model builder hands back to benches and tests, and
the synthetic classification batch (counterpart of
paddle_tpu/models/common.py)."""

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


def class_batch(batch_size: int, img_shape, num_classes: int,
                img_name: str = "image", label_name: str = "label",
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Uniform [0, 1) images and uniform int64 labels from ``seed``."""
    rng = np.random.RandomState(seed)
    return {
        img_name: rng.rand(batch_size, *img_shape).astype(np.float32),
        label_name: rng.randint(0, num_classes,
                                size=(batch_size, 1)).astype(np.int64),
    }
