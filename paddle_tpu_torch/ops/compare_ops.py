"""Compare ops (counterpart of paddle_tpu/ops/compare_ops.py): bool
outputs, fluid broadcasting."""

from __future__ import annotations

from ..core.proto import DataType
from ..core.registry import register_op
from .common import broadcast_out_shape, broadcast_y, in_desc, set_output


def _bool_out_shape(op, block):
    x = in_desc(op, block, "X")
    y = in_desc(op, block, "Y")
    if x is None:
        return
    shape = (broadcast_out_shape(x.shape, y.shape) if y is not None
             else list(x.shape))
    set_output(block, op, "Out", shape, DataType.BOOL, lod_level=x.lod_level)


def _make_compare(name, fn):
    @register_op(name, infer_shape=_bool_out_shape, no_grad=True)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [_fn(x, broadcast_y(x, y, attrs.get("axis", -1)))]}

    return _lower


_make_compare("not_equal", lambda x, y: x != y)
