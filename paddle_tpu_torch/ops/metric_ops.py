"""Metric ops (counterpart of paddle_tpu/ops/metric_ops.py): accuracy."""

from __future__ import annotations

import torch

from ..core.proto import DataType
from ..core.registry import register_op
from .common import in_desc, set_output


def _accuracy_infer(op, block):
    if in_desc(op, block, "Out") is None:
        return
    set_output(block, op, "Accuracy", [1], DataType.FP32)
    set_output(block, op, "Correct", [1], DataType.INT32)
    set_output(block, op, "Total", [1], DataType.INT32)


@register_op("accuracy", infer_shape=_accuracy_infer, no_grad=True)
def _accuracy(ctx, ins, attrs):
    """Top-k accuracy from top_k's Indices [N, k] and Label [N, 1]."""
    idx = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    correct = (idx == label).any(dim=1).sum().to(torch.int32).reshape(1)
    total = idx.shape[0]
    return {"Accuracy": [correct.to(torch.float32) / total],
            "Correct": [correct],
            "Total": [torch.full((1,), total, dtype=torch.int32,
                                 device=idx.device)]}
