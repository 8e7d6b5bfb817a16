"""Eager block runner (counterpart of paddle_tpu/core/compiler.py).

The JAX package lowers a whole block into one jitted XLA computation.  The
port runs it eagerly: each op's registered torch rule is called in program
order on the tensors of an environment keyed by variable name.

Gradient ops keep the reference's contract — gradients are ops in the
program, with no per-op gradient code.  The JAX compiler stashes a
``jax.vjp`` closure per forward op; the counterpart here is:

- a forward op whose ``__op_uid__`` some grad op names runs its rule
  under grad mode on its inputs, detached, with ``requires_grad`` set on
  the float ones that grad op writes a gradient for (so no kernel computes
  a gradient nobody reads, e.g. the fed image's), and stashes (inputs,
  outputs) — the autograd graph of that one op;
- its ``<type>_grad`` op calls ``torch.autograd.grad`` on the stashed
  outputs with the ``<slot>@GRAD`` cotangents of the environment;
- a non-float input, or one the op's outputs do not depend on, gets zeros
  where a grad slot names it (as the JAX compiler gives ``_Const`` inputs).

Every other op runs under ``torch.no_grad()``.  Each op's inputs are
detached, so no autograd graph spans two ops.

A rule may skip an output that nothing reads (``ctx.is_read``): the JAX
package gets this from XLA's dead-code elimination.  For the same reason a
value leaves the environment after the last op that reads it (unless the
caller keeps it): an activation gradient goes once its grad op has run,
instead of living to the end of the step.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

import torch

from .proto import OpDesc
from .registry import GRAD_OP_SUFFIX, GRAD_SUFFIX, OpRegistry

__all__ = ["LoweringContext", "run_block"]

# ops handled by the executor itself, not lowered
_SKIP_OPS = {"feed", "fetch"}


class LoweringContext:
    """Carried state while running one block: the environment, the device
    that fills and initializers allocate on, the random stream, and the
    stashed forward graphs by op uid."""

    def __init__(self, env: Dict[str, Any], device: torch.device,
                 generator: torch.Generator):
        self.env = env
        self.device = device
        self.generator = generator
        # uid -> (float inputs {(slot, pos): leaf}, outputs {(slot, pos): t})
        self.stash: Dict[int, Any] = {}
        # names some op looks up, or the caller keeps; set by run_block
        self.reads: Set[str] = set()
        self.op: Optional[OpDesc] = None  # the op being lowered

    def is_read(self, slot: str) -> bool:
        """Whether anything reads an output of the current op's ``slot``."""
        return any(n in self.reads for n in self.op.outputs.get(slot, ()))

    def lookup(self, name: str):
        if not name:
            return None
        if name not in self.env:
            raise KeyError(f"variable '{name}' used before definition")
        return self.env[name]


def _bind_outputs(ctx: LoweringContext, op: OpDesc,
                  outs: Dict[str, List[Any]]) -> None:
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != len(names):
            raise ValueError(f"op {op.type} slot {slot}: rule produced "
                             f"{len(vals)} values for {len(names)} outputs")
        for name, val in zip(names, vals):
            if name and val is not None:
                ctx.env[name] = val


def _run_forward_op(ctx: LoweringContext, op: OpDesc,
                    wanted: Optional[Set[tuple]]):
    """``wanted``: the (slot, pos) inputs whose gradients the op's grad op
    writes; None when no grad op names this op."""
    info = OpRegistry.get(op.type)
    ctx.op = op
    ins = {slot: [ctx.lookup(n) for n in names]
           for slot, names in op.inputs.items()}
    attrs = dict(op.attrs)
    if wanted is None or info.no_grad:
        with torch.no_grad():
            _bind_outputs(ctx, op, info.lower(ctx, ins, attrs))
        return
    leaves = {}
    for slot, row in ins.items():
        for pos, v in enumerate(row):
            if ((slot, pos) in wanted and v is not None
                    and v.is_floating_point()):
                row[pos] = leaves[(slot, pos)] = v.detach().requires_grad_()
    with torch.enable_grad():
        outs = info.lower(ctx, ins, attrs)
    ctx.stash[attrs["__op_uid__"]] = (leaves, {
        (slot, pos): t for slot, row in outs.items()
        for pos, t in enumerate(row) if t is not None})
    _bind_outputs(ctx, op, {slot: [None if t is None else t.detach()
                                   for t in row]
                            for slot, row in outs.items()})


def _run_grad_op(ctx: LoweringContext, op: OpDesc) -> None:
    uid = op.attrs["__fwd_op_uid__"]
    if uid not in ctx.stash:
        raise RuntimeError(f"grad op {op.type} has no recorded forward op "
                           f"(uid={uid}); was append_backward run on this "
                           "program?")
    leaves, outs = ctx.stash.pop(uid)
    roots, cotangents = [], []
    for (slot, pos), out in outs.items():
        gnames = op.inputs.get(slot + GRAD_SUFFIX, [])
        g = ctx.env.get(gnames[pos]) if pos < len(gnames) and gnames[pos] \
            else None
        if g is not None and out.requires_grad:
            roots.append(out)
            cotangents.append(g.to(out.dtype))
    keys = list(leaves)
    grads = (torch.autograd.grad(roots, [leaves[k] for k in keys],
                                 cotangents, allow_unused=True)
             if roots and keys else [None] * len(keys))
    by_key = dict(zip(keys, grads))
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            continue
        fwd_slot = slot[:-len(GRAD_SUFFIX)]
        for pos, name in enumerate(names):
            if not name:
                continue
            g = by_key.get((fwd_slot, pos))
            if g is None:
                # a non-float input, or one the outputs do not depend on
                g = torch.zeros_like(ctx.lookup(op.inputs[fwd_slot][pos]))
            ctx.env[name] = g


def _is_grad_op(op: OpDesc) -> bool:
    return op.type.endswith(GRAD_OP_SUFFIX) and "__fwd_op_uid__" in op.attrs


def _names_looked_up(op: OpDesc) -> Iterable[str]:
    """The env names running ``op`` reads.  A grad op reads its cotangents
    and, for zeros, the forward inputs it writes gradients for; the forward
    outputs it names come from the stash."""
    if not _is_grad_op(op):
        return op.input_arg_names()
    return [n for slot, names in op.inputs.items()
            if slot.endswith(GRAD_SUFFIX)
            or slot + GRAD_SUFFIX in op.outputs for n in names]


def run_block(ctx: LoweringContext, ops: Sequence[OpDesc],
              keep: Iterable[str] = ()) -> None:
    """Run ``ops`` in order against ``ctx.env``; ``keep`` names the vars
    the caller reads afterwards (fetches, scope state)."""
    keep = set(keep)
    looked_up = [list(_names_looked_up(op)) for op in ops]
    ctx.reads = keep.union(*looked_up)
    last_read: Dict[str, int] = {}
    for i, names in enumerate(looked_up):
        for name in names:
            last_read[name] = i
    wanted: Dict[int, Set[tuple]] = {}
    for op in ops:
        if "__fwd_op_uid__" in op.attrs:
            wanted.setdefault(op.attrs["__fwd_op_uid__"], set()).update(
                (slot[:-len(GRAD_SUFFIX)], pos)
                for slot, names in op.outputs.items()
                if slot.endswith(GRAD_SUFFIX)
                for pos, name in enumerate(names) if name)
    for i, op in enumerate(ops):
        if op.type in _SKIP_OPS:
            continue
        if _is_grad_op(op):
            _run_grad_op(ctx, op)
        elif not OpRegistry.has(op.type):
            raise NotImplementedError(f"op '{op.type}' has no torch rule")
        else:
            _run_forward_op(ctx, op, wanted.get(op.attrs.get("__op_uid__")))
        for name in looked_up[i] + op.output_arg_names():
            if name not in keep and last_read.get(name, -1) <= i:
                ctx.env.pop(name, None)
