"""Activation layers generated from their ops (counterpart of
paddle_tpu/layers/ops.py): one layer function per activation op the
ported models call."""

from __future__ import annotations

from ..layer_helper import LayerHelper

_ACTIVATIONS = ["sigmoid", "square"]

__all__ = list(_ACTIVATIONS)


def _make_act(op_type):
    def layer_fn(x, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]})
        return out

    layer_fn.__name__ = op_type
    layer_fn.__doc__ = f"{op_type} activation (op-generated layer fn)"
    return layer_fn


for _op in _ACTIVATIONS:
    globals()[_op] = _make_act(_op)
