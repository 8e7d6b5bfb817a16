"""Tensor creation / manipulation ops (counterpart of
paddle_tpu/ops/tensor_ops.py): fills, assign, the uniform and gaussian
initializers, reshape2 / squeeze2 / transpose2, split, lookup_table and
its gradient rule."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.proto import DataType, dtype_to_torch
from ..core.registry import register_op
from ..core.selected_rows import SelectedRowsValue, segment_sum
from .common import in_desc, set_output


def _dtype(attrs):
    return dtype_to_torch(DataType(attrs.get("dtype", int(DataType.FP32))))


# -- fills -------------------------------------------------------------------
def _fill_constant_infer(op, block):
    set_output(block, op, "Out", list(op.attr("shape", [1])),
               DataType(op.attr("dtype", int(DataType.FP32))))


@register_op("fill_constant", infer_shape=_fill_constant_infer, no_grad=True)
def _fill_constant(ctx, ins, attrs):
    shape = [int(d) for d in attrs.get("shape", [1])]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=_dtype(attrs), device=ctx.device)]}


def _fill_bsl_infer(op, block):
    x = in_desc(op, block, "Input")
    shape = list(op.attr("shape", [1]))
    if x is not None:
        in_idx = op.attr("input_dim_idx", 0)
        out_idx = op.attr("output_dim_idx", 0)
        if in_idx < len(x.shape):
            shape[out_idx] = x.shape[in_idx]
    set_output(block, op, "Out", shape,
               DataType(op.attr("dtype", int(DataType.FP32))))


@register_op("fill_constant_batch_size_like", infer_shape=_fill_bsl_infer,
             no_grad=True)
def _fill_constant_batch_size_like(ctx, ins, attrs):
    """Fill with the batch dim copied from a runtime input."""
    x = ins["Input"][0]
    shape = [int(d) for d in attrs.get("shape", [1])]
    shape[attrs.get("output_dim_idx", 0)] = x.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=_dtype(attrs), device=x.device)]}


def _fill_like_infer(op, block):
    x = in_desc(op, block, "X")
    if x is not None:
        set_output(block, op, "Out", x.shape, x.dtype)


@register_op("assign", infer_shape=_fill_like_infer)
def _assign(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("assign_value", infer_shape=_fill_constant_infer, no_grad=True)
def _assign_value(ctx, ins, attrs):
    """The constant is built on the device once (``ctx.constant``) and
    read by every later run: its copy from host memory cannot be captured
    into a CUDA graph."""
    vals = (attrs.get("fp32_values") or attrs.get("int32_values")
            or attrs.get("values") or [])
    arr = np.asarray(vals, dtype=np.float64).reshape(attrs["shape"])
    dtype = _dtype(attrs)
    return {"Out": [ctx.constant(
        ("assign_value", arr.shape, dtype, arr.tobytes()),
        lambda: torch.as_tensor(arr, device=ctx.device).to(dtype))]}


# -- random ------------------------------------------------------------------
@register_op("uniform_random", infer_shape=_fill_constant_infer,
             no_grad=True)
def _uniform_random(ctx, ins, attrs):
    """U[min, max) from the program's torch.Generator (its numbers are not
    jax's for the same seed)."""
    shape = [int(d) for d in attrs["shape"]]
    out = torch.empty(shape, dtype=_dtype(attrs), device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": [out]}


@register_op("gaussian_random", infer_shape=_fill_constant_infer,
             no_grad=True)
def _gaussian_random(ctx, ins, attrs):
    """N(mean, std^2) from the program's torch.Generator."""
    shape = [int(d) for d in attrs["shape"]]
    out = torch.empty(shape, dtype=_dtype(attrs), device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator)
    return {"Out": [out]}


# -- reshape family ----------------------------------------------------------
def _resolve_reshape(in_shape, target):
    out = [in_shape[i] if d == 0 else int(d) for i, d in enumerate(target)]
    if -1 in out:
        known = 1
        for d in out:
            if d != -1:
                known *= d
        total = 1
        for d in in_shape:
            total *= d
        out[out.index(-1)] = total // known
    return out


def _reshape_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    target = list(op.attr("shape", []))
    shape = list(x.shape)
    if all(d >= 0 for d in shape):
        shape = _resolve_reshape(shape, target)
    else:
        shape = [shape[i] if d == 0 else d for i, d in enumerate(target)]
    lod = x.lod_level if (target and target[0] in (-1, 0)) else 0
    set_output(block, op, "Out", shape, x.dtype, lod_level=lod)
    if op.output("XShape"):
        set_output(block, op, "XShape", [0] + list(x.shape), x.dtype)


@register_op("reshape2", infer_shape=_reshape_infer, diff_inputs=["X"])
def _reshape2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_resolve_reshape(list(x.shape),
                                               list(attrs["shape"])))]}


def _squeeze_axes(shape, axes):
    if axes:
        axes = [a + len(shape) if a < 0 else a for a in axes]
        return [d for i, d in enumerate(shape) if not (i in axes and d == 1)]
    return [d for d in shape if d != 1]


def _squeeze_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Out",
               _squeeze_axes(list(x.shape), op.attr("axes", [])), x.dtype)
    if op.output("XShape"):
        set_output(block, op, "XShape", [0] + list(x.shape), x.dtype)


@register_op("squeeze2", infer_shape=_squeeze_infer, diff_inputs=["X"])
def _squeeze2(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.reshape(_squeeze_axes(list(x.shape),
                                            attrs.get("axes", [])))]}


def _transpose_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    axis = op.attr("axis", [])
    set_output(block, op, "Out", [x.shape[a] for a in axis], x.dtype)
    if op.output("XShape"):
        set_output(block, op, "XShape", [0] + list(x.shape), x.dtype)


@register_op("transpose2", infer_shape=_transpose_infer, diff_inputs=["X"])
def _transpose2(ctx, ins, attrs):
    return {"Out": [ins["X"][0].permute(*attrs["axis"])]}


# -- embedding ---------------------------------------------------------------
def _split_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    axis = op.attr("axis", 0)
    axis = axis + len(x.shape) if axis < 0 else axis
    num = op.attr("num", 0)
    sections = op.attr("sections", [])
    for i in range(len(op.output("Out"))):
        shape = list(x.shape)
        if sections:
            shape[axis] = sections[i]
        elif num:
            shape[axis] = x.shape[axis] // num if x.shape[axis] >= 0 else -1
        set_output(block, op, "Out", shape, x.dtype, idx=i,
                   lod_level=x.lod_level if axis >= 1 else 0)


@register_op("split", infer_shape=_split_infer)
def _split(ctx, ins, attrs):
    """``num`` equal parts along ``axis``, or cut at the running sums of
    ``sections`` (the last part is the rest), as jnp.split cuts."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        return {"Out": list(torch.tensor_split(
            x, np.cumsum(sections)[:-1].tolist(), dim=axis))}
    num = attrs.get("num", 1)
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does "
                         f"not divide into {num} equal parts")
    return {"Out": list(torch.tensor_split(x, num, dim=axis))}


def _lookup_infer(op, block):
    w = in_desc(op, block, "W")
    ids = in_desc(op, block, "Ids")
    if w is None or ids is None:
        return
    shape = list(ids.shape)
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    set_output(block, op, "Out", shape + [w.shape[1]], w.dtype,
               lod_level=ids.lod_level)


@register_op("lookup_table", infer_shape=_lookup_infer, diff_inputs=["W"])
def _lookup_table(ctx, ins, attrs):
    """Embedding lookup; rows at padding_idx read as zeros, so (through
    the mask) they take no gradient either.  ``F.embedding``: on the card
    its backward sums each row's gradients in a fixed order (sorted, not
    by atomic adds), so two runs of a step are bit-equal."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() >= 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = F.embedding(ids, w)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register_op("lookup_table_grad", no_grad=True)
def _lookup_table_grad(ctx, ins, attrs):
    """The table's gradient, in place of the autograd replay (the JAX
    package registers the same rule).  With ``is_sparse`` it is a
    SelectedRowsValue: the looked-up ids and the output gradient's rows,
    padding_idx slots dead, V in no buffer; the optimizer ops update only
    the rows it names.  Without, the dense [V, D] sum of F.embedding's
    backward on the masked output gradient, the very call autograd makes
    for the forward rule above."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    if ids.dim() >= 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    height, dim = w.shape
    og = ins["Out@GRAD"][0].to(w.dtype)
    padding_idx = attrs.get("padding_idx", -1)
    padded = padding_idx is not None and padding_idx >= 0
    if not attrs.get("is_sparse", False):
        if padded:  # the forward's mask, differentiated
            og = og * (ids != padding_idx).unsqueeze(-1).to(og.dtype)
        return {"W@GRAD": [segment_sum(og, ids, height)]}
    ids = ids.reshape(-1)
    live = (ids != padding_idx if padded
            else torch.ones_like(ids, dtype=torch.bool))
    return {"W@GRAD": [SelectedRowsValue(ids, og.reshape(-1, dim), height,
                                         live)]}
