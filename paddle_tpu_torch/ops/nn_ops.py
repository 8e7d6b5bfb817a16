"""Normalisation ops (counterpart of paddle_tpu/ops/nn_ops.py):
layer_norm."""

from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import in_desc, set_output


def _layer_norm_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Y", x.shape, x.dtype)
    begin = op.attr("begin_norm_axis", 1)
    lead = 1
    ok = all(d >= 0 for d in x.shape[:begin])
    for d in x.shape[:begin]:
        lead *= d
    set_output(block, op, "Mean", [lead if ok else -1], x.dtype)
    set_output(block, op, "Variance", [lead if ok else -1], x.dtype)


@register_op("layer_norm", infer_shape=_layer_norm_infer,
             diff_inputs=["X", "Scale", "Bias"])
def _layer_norm(ctx, ins, attrs):
    """Normalize over the dims from begin_norm_axis on (population
    variance), then scale and shift."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    tail_shape = (1,) * begin + tuple(x.shape[begin:])
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    if scale is not None:
        y = y * scale.reshape(tail_shape)
    if bias is not None:
        y = y + bias.reshape(tail_shape)
    return {"Y": [y], "Mean": [mean.reshape(-1)],
            "Variance": [var.reshape(-1)]}
