"""Compare layers (counterpart of paddle_tpu/layers/control_flow.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["not_equal"]


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, input=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [cond]})
    return cond


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)
