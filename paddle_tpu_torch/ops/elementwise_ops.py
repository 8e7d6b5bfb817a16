"""Elementwise binary ops with fluid broadcasting (counterpart of
paddle_tpu/ops/elementwise_ops.py): Y broadcasts as a contiguous sub-shape
of X anchored at ``axis``."""

from __future__ import annotations

from ..core import amp
from ..core.registry import register_op
from .common import broadcast_y, elemwise_shape


def _make(name, fn):
    @register_op(name, infer_shape=elemwise_shape)
    def _lower(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        # amp keep_output: an fp32 bias or scale must not re-widen a bf16
        # activation chain through promotion
        return {"Out": [_fn(*amp.match_kept(
            x, broadcast_y(x, y, attrs.get("axis", -1))))]}

    return _lower


_make("elementwise_add", lambda x, y: x + y)
_make("elementwise_sub", lambda x, y: x - y)
_make("elementwise_mul", lambda x, y: x * y)
_make("elementwise_div", lambda x, y: x / y)
