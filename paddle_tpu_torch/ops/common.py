"""Shared helpers for op rules: desc lookups and output-desc setters for
``infer_shape``, fluid broadcasting for the lowerings (counterpart of
paddle_tpu/ops/common.py)."""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.proto import DataType, OpDesc, VarDesc

__all__ = ["broadcast_out_shape", "broadcast_y", "elemwise_shape",
           "in_desc", "same_shape", "set_output"]


def in_desc(op: OpDesc, block, slot: str, idx: int = 0) -> Optional[VarDesc]:
    names = op.input(slot)
    if idx >= len(names) or not names[idx]:
        return None
    v = block._find_var_recursive(names[idx])
    return v.desc if v is not None else None


def set_output(block, op: OpDesc, slot: str, shape: Sequence[int],
               dtype: DataType, idx: int = 0,
               lod_level: Optional[int] = None):
    names = op.output(slot)
    if idx >= len(names) or not names[idx]:
        return
    name = names[idx]
    if block.desc.has_var(name):
        vd = block.desc.vars[name]
        vd.shape = list(shape)
        vd.dtype = DataType(dtype)
        if lod_level is not None:
            vd.lod_level = lod_level
    else:
        block.create_var(name=name, shape=list(shape), dtype=DataType(dtype),
                         lod_level=lod_level or 0)


def same_shape(in_slot: str = "X", out_slot: str = "Out"):
    """infer_shape factory: Out mirrors X's shape/dtype/lod."""

    def infer(op: OpDesc, block):
        x = in_desc(op, block, in_slot)
        if x is None:
            return
        set_output(block, op, out_slot, x.shape, x.dtype,
                   lod_level=x.lod_level)

    return infer


def elemwise_shape(op: OpDesc, block):
    x = in_desc(op, block, "X")
    y = in_desc(op, block, "Y")
    if x is None:
        return
    if y is not None and len(y.shape) == len(x.shape):
        shape = broadcast_out_shape(x.shape, y.shape)
    elif y is not None and len(y.shape) > len(x.shape):
        shape = list(y.shape)
    else:
        shape = list(x.shape)
    set_output(block, op, "Out", shape, x.dtype, lod_level=x.lod_level)


def broadcast_y(x, y, axis: int):
    """Fluid elementwise broadcasting: a lower-rank Y is a contiguous
    sub-sequence of X's shape aligned at ``axis`` (-1 = the trailing
    dims); it is reshaped so torch broadcasting applies.  Equal-rank
    operands broadcast as they are."""
    if y.dim() >= x.dim():
        return y
    ys = list(y.shape)
    while ys and ys[-1] == 1 and len(ys) > 1:  # fluid: [N, 1] vs [N]
        ys = ys[:-1]
    axis = x.dim() - len(ys) if axis == -1 else axis
    target = [1] * x.dim()
    for i, d in enumerate(ys):
        target[axis + i] = d
    return y.reshape(target)


def broadcast_out_shape(x_shape, y_shape):
    """Static result shape of broadcasting x with y (-1 is an unknown
    batch dim: -1 with 1 or -1 stays -1, else the known dim)."""
    if len(y_shape) > len(x_shape):
        x_shape, y_shape = y_shape, x_shape
    out = list(x_shape)
    off = len(x_shape) - len(y_shape)
    for i, dy in enumerate(y_shape):
        dx = out[off + i]
        if dx == dy:
            continue
        if dx == 1:
            out[off + i] = dy
        elif dy == 1:
            continue
        elif dx == -1 or dy == -1:
            out[off + i] = -1
        else:
            out[off + i] = max(dx, dy)
    return out
