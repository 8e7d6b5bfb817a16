"""Activation ops (counterpart of paddle_tpu/ops/activation_ops.py)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import same_shape


@register_op("relu", infer_shape=same_shape())
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}
