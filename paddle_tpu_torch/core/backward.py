"""Desc-level reverse-mode autodiff: append_backward (counterpart of
paddle_tpu/core/backward.py).

Gradients are *ops in the program*: a reverse walk from the loss appends
one ``<type>_grad`` op per forward op on the path, ``sum`` ops where a
variable's gradient has several producers, and the grad VarDescs.  There
is no per-op gradient code: each grad op names its forward op by uid
(attr ``__fwd_op_uid__``), and the block runner (core/compiler.py)
differentiates that forward op's lowering with ``torch.autograd.grad``.

The uids come from a process-global counter, as in the JAX package, so two
builds of one model carry different raw uids when the process built other
programs first; compare programs after renumbering the uids by first
appearance.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .framework import Block, Parameter, Program, Variable, grad_var_name
from .proto import OpDesc
from .registry import GRAD_OP_SUFFIX, GRAD_SUFFIX, OpRegistry

__all__ = ["append_backward"]

_uid_counter = itertools.count(1)


def _assign_op_uid(opdesc: OpDesc) -> int:
    uid = opdesc.attrs.get("__op_uid__")
    if uid is None:
        uid = next(_uid_counter)
        opdesc.attrs["__op_uid__"] = uid
    return uid


def _find_op_path(
    block: Block, targets: Set[str], param_names: Set[str], no_grad: Set[str]
) -> List[int]:
    """Indices of ops on any path from relevant inputs to the targets."""
    ops = block.desc.ops
    # backward sweep: which vars are relevant (can influence a target)
    relevant = set(targets)
    path_rev: List[int] = []
    for i in range(len(ops) - 1, -1, -1):
        op = ops[i]
        outs = set(op.output_arg_names())
        if outs & relevant:
            path_rev.append(i)
            relevant |= set(op.input_arg_names()) - no_grad
    return list(reversed(path_rev))


def _creates_grad(op_type: str) -> bool:
    if not OpRegistry.has(op_type):
        return True
    return not OpRegistry.get(op_type).no_grad


def _make_grad_op(
    fwd: OpDesc, block: Block, no_grad: Set[str], grad_produced: Set[str]
) -> Optional[OpDesc]:
    """Generic grad-desc maker.  Convention: grad-op inputs are the forward
    inputs and outputs under their own slot names plus output-gradients under
    `<slot>@GRAD`; outputs are input-gradients under `<slot>@GRAD`."""
    info = OpRegistry.get(fwd.type) if OpRegistry.has(fwd.type) else None

    uid = _assign_op_uid(fwd)
    grad = OpDesc(type=fwd.type + GRAD_OP_SUFFIX)
    grad.attrs = {
        k: v for k, v in fwd.attrs.items() if not k.startswith("__op_uid")
    }
    grad.attrs["__fwd_op_uid__"] = uid

    for slot, names in fwd.inputs.items():
        grad.inputs[slot] = list(names)
    for slot, names in fwd.outputs.items():
        grad.inputs[slot] = list(names)
        og = [grad_var_name(n) for n in names]
        # only wire output-grads that some later (in backward order) op
        # actually produced; missing ones are treated as zeros by the compiler
        grad.inputs[slot + GRAD_SUFFIX] = [
            g if g in grad_produced else "" for g in og
        ]

    diff_slots = info.diff_inputs if (info and info.diff_inputs is not None) else list(
        fwd.inputs.keys()
    )
    any_out = False
    for slot in diff_slots:
        names = fwd.inputs.get(slot, [])
        outs = []
        for n in names:
            v = block._find_var_recursive(n)
            if n in no_grad or (v is not None and v.stop_gradient):
                outs.append("")
            else:
                outs.append(grad_var_name(n))
                any_out = True
        grad.outputs[slot + GRAD_SUFFIX] = outs
    if not any_out:
        return None
    # does any produced output-grad actually feed this op?
    has_live_input_grad = any(
        g for slot in fwd.outputs for g in grad.inputs.get(slot + GRAD_SUFFIX, [])
    )
    if not has_live_input_grad:
        return None
    return grad


def _create_grad_vars(block: Block, grad_op: OpDesc) -> None:
    """Create VarDescs for produced grads, shaped like their forward vars."""
    for slot, names in grad_op.outputs.items():
        for name in names:
            if not name or block.desc.has_var(name):
                continue
            fwd_name = name[: -len(GRAD_SUFFIX)] if name.endswith(GRAD_SUFFIX) else name
            fwd_name = fwd_name.split("@RENAME@")[0]
            fv = block._find_var_recursive(fwd_name)
            if fv is not None:
                block.create_var(
                    name=name, shape=list(fv.shape), dtype=fv.dtype, stop_gradient=True
                )
            else:
                block.create_var(name=name, stop_gradient=True)


def _dedup_grad_outputs(
    grad_ops: List[OpDesc], block: Block
) -> List[OpDesc]:
    """Insert `sum` ops where several grad ops produce the same gradient.

    Walks the backward op list in execution order renaming duplicate
    producers to `<g>@RENAME@i`, then sums them into `<g>` right after the
    last producer.
    """
    produced_count: Dict[str, int] = defaultdict(int)
    for op in grad_ops:
        for names in op.outputs.values():
            for n in names:
                if n:
                    produced_count[n] += 1
    dup = {n for n, c in produced_count.items() if c > 1}
    if not dup:
        return grad_ops

    # SSA versioning in execution order.  Two producer kinds:
    # * parallel contribution (forward var had several consumers) — summed
    #   with the running total right after the producing op;
    # * in-place flow-through (op consumes AND produces the same grad, e.g.
    #   while_grad over a loop-carried var) — chained: the op reads the
    #   current version and its output becomes the new current version.
    version: Dict[str, int] = defaultdict(int)
    cur: Dict[str, str] = {}

    def fresh(n: str) -> str:
        v = f"{n}@RENAME@{version[n]}"
        version[n] += 1
        return v

    out_ops: List[OpDesc] = []
    for op in grad_ops:
        orig_in = {x for row in op.inputs.values() for x in row}
        for names in op.inputs.values():
            for j, n in enumerate(names):
                if n in dup and n in cur:
                    names[j] = cur[n]
        pending_sums: List[OpDesc] = []
        for names in op.outputs.values():
            for j, n in enumerate(names):
                if n not in dup:
                    continue
                v = fresh(n)
                names[j] = v
                if n in orig_in:
                    cur[n] = v  # chain
                elif n in cur:
                    w = fresh(n)
                    pending_sums.append(
                        OpDesc(type="sum", inputs={"X": [cur[n], v]},
                               outputs={"Out": [w]})
                    )
                    cur[n] = w
                else:
                    cur[n] = v
        out_ops.append(op)
        out_ops.extend(pending_sums)

    # bind the final version to the canonical grad name
    for n, v in cur.items():
        out_ops.append(
            OpDesc(type="assign", inputs={"X": [v]}, outputs={"Out": [n]})
        )
    return out_ops


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
) -> List[Tuple[Parameter, Variable]]:
    """Append backward ops computing d(loss)/d(param) for every trainable
    parameter; returns [(param, grad_var)]."""
    program: Program = loss.block.program
    block = loss.block
    if block.idx != 0:
        raise NotImplementedError("append_backward from a sub-block is not supported")

    no_grad: Set[str] = set(no_grad_set or ())
    for v in program.list_vars():
        if v.stop_gradient:
            no_grad.add(v.name)

    if parameter_list is not None:
        params = [block.program.global_block().var(n) for n in parameter_list]
    else:
        params = [p for p in program.all_parameters() if getattr(p, "trainable", True)]
    param_names = {p.name for p in params}

    if list(loss.shape) not in ([1], []):
        raise ValueError(f"loss must be a scalar, got shape {list(loss.shape)}")

    op_path = _find_op_path(block, {loss.name}, param_names, no_grad)

    # seed: d(loss)/d(loss) = 1
    loss_grad = grad_var_name(loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad]},
        attrs={
            "shape": list(loss.shape) or [1],
            "value": 1.0,
            "dtype": int(loss.dtype),
            "force_cpu": False,
        },
    )
    block.desc.vars[loss_grad].stop_gradient = True
    block.desc.vars[loss_grad].shape = list(loss.shape)
    block.desc.vars[loss_grad].dtype = loss.dtype

    grad_produced: Set[str] = {loss_grad}
    grad_ops: List[OpDesc] = []
    for i in reversed(op_path):
        fwd = block.desc.ops[i]
        if not _creates_grad(fwd.type):
            continue
        g = _make_grad_op(fwd, block, no_grad, grad_produced)
        if g is None:
            continue
        grad_ops.append(g)
        for names in g.outputs.values():
            grad_produced.update(n for n in names if n)

    grad_ops = _dedup_grad_outputs(grad_ops, block)

    for g in grad_ops:
        block.desc.ops.append(g)
        # wrap as Operator for the python-level op list (skip infer_shape —
        # grad var shapes mirror their forward vars)
        from .framework import Operator

        op = Operator.__new__(Operator)
        op.block = block
        op.desc = g
        block.ops.append(op)
        _create_grad_vars(block, g)

    params_and_grads: List[Tuple[Parameter, Variable]] = []
    for p in params:
        gname = grad_var_name(p.name)
        if block.desc.has_var(gname):
            gv = block.var(gname)
            params_and_grads.append((p, gv))
    return params_and_grads
