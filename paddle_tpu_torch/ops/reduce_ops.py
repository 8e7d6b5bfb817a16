"""Reductions (counterpart of paddle_tpu/ops/reduce_ops.py): reduce_sum
and top_k."""

from __future__ import annotations

import torch

from ..core import amp
from ..core.proto import DataType
from ..core.registry import register_op
from .common import in_desc, set_output


def _reduce_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    dims = op.attr("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    keep = op.attr("keep_dim", False)
    lod = 0
    if op.attr("reduce_all", False):
        shape = [1] * len(x.shape) if keep else [1]
    else:
        rank = len(x.shape)
        dims = [d + rank if d < 0 else d for d in dims]
        if keep:
            shape = [1 if i in dims else d for i, d in enumerate(x.shape)]
        else:
            shape = [d for i, d in enumerate(x.shape) if i not in dims] or [1]
        if all(d >= 1 for d in dims):  # feature-axis reductions keep lod
            lod = x.lod_level
    set_output(block, op, "Out", shape, x.dtype, lod_level=lod)


@register_op("reduce_sum", infer_shape=_reduce_infer)
def _reduce_sum(ctx, ins, attrs):
    x = ins["X"][0]
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    keep = attrs.get("keep_dim", False)
    # a half-width input (amp keep_output) accumulates in fp32
    xa = x.to(amp.stats_dtype(x))
    if attrs.get("reduce_all", False):
        out = xa.sum(dim=tuple(range(x.dim())), keepdim=keep)
    else:
        out = xa.sum(dim=tuple(dims), keepdim=keep)
    # the output keeps the input's dtype (torch widens integer sums to
    # int64, half-width ones were widened above)
    out = out.to(x.dtype)
    return {"Out": [out.reshape(1) if out.dim() == 0 else out]}


def _topk_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    shape = list(x.shape[:-1]) + [op.attr("k", 1)]
    set_output(block, op, "Out", shape, x.dtype)
    set_output(block, op, "Indices", shape, DataType.INT64)


@register_op("top_k", infer_shape=_topk_infer, diff_inputs=[])
def _top_k(ctx, ins, attrs):
    """Values and int64 indices of the k largest along the last dim."""
    vals, idx = torch.topk(ins["X"][0], attrs.get("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}
