"""Dense linear algebra + scalar math ops (counterpart of
paddle_tpu/ops/math_ops.py): mul, matmul, scale, sum, mean, cast.  A
plain product stays ``torch.matmul``, as the JAX package leaves it to
XLA."""

from __future__ import annotations

import math

import torch

from ..core import amp
from ..core.proto import DataType, dtype_to_torch
from ..core.registry import register_op
from .common import in_desc, same_shape, set_output


def _mul_infer(op, block):
    x = in_desc(op, block, "X")
    y = in_desc(op, block, "Y")
    if x is None or y is None:
        return
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    set_output(block, op, "Out", list(x.shape[:xn]) + list(y.shape[yn:]),
               x.dtype)


@register_op("mul", infer_shape=_mul_infer)
def _mul(ctx, ins, attrs):
    """out = flatten2(X) @ flatten2(Y): X's dims before x_num_col_dims
    are rows, Y's before y_num_col_dims the contracted dim."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xn]), -1)
    y2 = y.reshape(math.prod(y.shape[:yn]), -1)
    out = amp.mxu_output(torch.matmul(*amp.mxu_operands(x2, y2)), x2, y2)
    return {"Out": [out.reshape(*x.shape[:xn], *y.shape[yn:])]}


def _matmul_infer(op, block):
    x = in_desc(op, block, "X")
    y = in_desc(op, block, "Y")
    if x is None or y is None:
        return
    tx, ty = op.attr("transpose_X", False), op.attr("transpose_Y", False)
    xs, ys = list(x.shape), list(y.shape)
    if len(xs) >= 2 and tx:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if len(ys) >= 2 and ty:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1 and len(ys) == 1:
        out = [1]
    elif len(xs) == 1:
        out = ys[:-2] + ys[-1:]
    elif len(ys) == 1:
        out = xs[:-1]
    else:
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        out = batch + [xs[-2], ys[-1]]
    set_output(block, op, "Out", out, x.dtype)


@register_op("matmul", infer_shape=_matmul_infer)
def _matmul(ctx, ins, attrs):
    """Batched matmul with optional transposes and scale."""
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() >= 2:
        y = y.transpose(-1, -2)
    out = amp.mxu_output(torch.matmul(*amp.mxu_operands(x, y)), x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("scale", infer_shape=same_shape())
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * scale + bias]}
    return {"Out": [(x + bias) * scale]}


def _sum_infer(op, block):
    x = in_desc(op, block, "X")
    if x is not None:
        set_output(block, op, "Out", x.shape, x.dtype, lod_level=x.lod_level)


@register_op("sum", infer_shape=_sum_infer)
def _sum(ctx, ins, attrs):
    """Add N tensors (also the gradient accumulator append_backward
    inserts)."""
    vals = [v for v in ins["X"] if v is not None]
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return {"Out": [out]}


def _mean_infer(op, block):
    x = in_desc(op, block, "X")
    if x is not None:
        set_output(block, op, "Out", [1], x.dtype)


@register_op("mean", infer_shape=_mean_infer)
def _mean(ctx, ins, attrs):
    # a half-width input accumulates in fp32; the output keeps its dtype
    x = ins["X"][0]
    return {"Out": [x.to(amp.stats_dtype(x)).mean().to(x.dtype).reshape(1)]}


def _cast_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Out", x.shape,
               DataType(op.attr("out_dtype", int(DataType.FP32))),
               lod_level=x.lod_level)


@register_op("cast", infer_shape=_cast_infer)
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(
        dtype_to_torch(DataType(attrs["out_dtype"])))]}
