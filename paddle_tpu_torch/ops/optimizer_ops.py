"""Optimizer ops (counterpart of paddle_tpu/ops/optimizer_ops.py):
parameter updates as ops in the program.  Each writes ``*Out`` slots whose
names alias its inputs; the executor writes them back to the scope.
Dense momentum only."""

from __future__ import annotations

from ..core.registry import register_op
from .common import in_desc, set_output


def _param_out_infer(op, block):
    p = in_desc(op, block, "Param")
    if p is None:
        return
    for slot in op.outputs:
        ref = in_desc(op, block, slot.replace("Out", "")) or p
        set_output(block, op, slot, ref.shape, ref.dtype)


@register_op("momentum", infer_shape=_param_out_infer, no_grad=True)
def _momentum(ctx, ins, attrs):
    if attrs.get("use_nesterov", False):
        raise NotImplementedError("Nesterov momentum is not ported")
    p = ins["Param"][0]
    g = ins["Grad"][0]
    v = ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = ins["LearningRate"][0].reshape(())
    v_new = mu * v + g
    p_new = p - lr * v_new
    return {"ParamOut": [p_new], "VelocityOut": [v_new]}
