"""Activation ops (counterpart of paddle_tpu/ops/activation_ops.py)."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import same_shape


def _unary(name, fn):
    @register_op(name, infer_shape=same_shape())
    def _lower(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0])]}

    return _lower


_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("square", torch.square)
