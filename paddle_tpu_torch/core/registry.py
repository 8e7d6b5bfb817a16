"""Operator registry (counterpart of paddle_tpu/core/registry.py).

An op is a *rule*: compile-time shape/dtype inference, run when the op is
appended to a block, plus a lowering — a function from torch tensors to
torch tensors that the eager block runner (core/compiler.py) calls.
Gradients need no per-op code: a ``<type>_grad`` op differentiates its
forward op's lowering with ``torch.autograd.grad``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

__all__ = ["GRAD_OP_SUFFIX", "GRAD_SUFFIX", "OpInfo", "OpRegistry",
           "register_op"]

GRAD_SUFFIX = "@GRAD"
GRAD_OP_SUFFIX = "_grad"


@dataclass
class OpInfo:
    type: str
    # infer_shape(op: OpDesc, block: "Block") -> None; sets output VarDesc
    # shape/dtype at graph-build time.
    infer_shape: Optional[Callable] = None
    # lower(ctx, ins: Dict[str, List[Tensor]], attrs) -> Dict[str, List]
    lower: Optional[Callable] = None
    # Ops with no gradient (fills, comparisons, optimizer updates).
    no_grad: bool = False
    # Slots that are differentiable inputs; None = all inputs.
    diff_inputs: Optional[List[str]] = None


class OpRegistry:
    _ops: Dict[str, OpInfo] = {}

    @classmethod
    def register(cls, info: OpInfo) -> None:
        if info.type in cls._ops:
            raise ValueError(f"op '{info.type}' registered twice")
        cls._ops[info.type] = info

    @classmethod
    def get(cls, op_type: str) -> OpInfo:
        if op_type not in cls._ops:
            raise KeyError(f"op '{op_type}' is not registered")
        return cls._ops[op_type]

    @classmethod
    def has(cls, op_type: str) -> bool:
        return op_type in cls._ops


def register_op(op_type: str, *, infer_shape: Optional[Callable] = None,
                no_grad: bool = False,
                diff_inputs: Optional[List[str]] = None):
    """Decorator registering ``fn`` as the lowering rule for ``op_type``."""

    def deco(fn: Optional[Callable]):
        OpRegistry.register(OpInfo(
            type=op_type, infer_shape=infer_shape, lower=fn, no_grad=no_grad,
            diff_inputs=diff_inputs))
        return fn

    return deco
