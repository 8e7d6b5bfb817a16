"""The detectors of the port's program linter (counterpart of
paddle_tpu/analysis/detectors.py).

Each detector is ``fn(ProgramArtifacts) -> List[Finding]`` over the
captured graph, with no execution.  The ids are stable API:

  broadcast-operand       a port kernel operand that is a broadcast
                          (``expand``, ``expand_as``, ``broadcast_to``,
                          possibly through
                          ``contiguous``, ``clone``, views and reshapes) of
                          a smaller tensor: the kernels read contiguous
                          memory, so the operand is materialised at full
                          size on every call (the lse residual class)
  shared-memory-overflow  a port kernel launch whose block asks for more
                          shared memory than the card gives one block
                          (analysis/kernels.py): the card refuses it.  Not
                          the reference's ``smem-overflow``, which prices
                          the TPU's scalar-prefetch memory

The reference's other detectors (relayout, donation, recompile, dtype
promotion, scan widening, host sync, collective placement, scalar
prefetch) have no counterpart yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .capture import ProgramArtifacts
from .findings import Finding
from .kernels import (NAMESPACE, detect_shared_memory_overflow,
                      iter_kernel_calls, op_name)

__all__ = ["DETECTORS", "detect_broadcast_operands", "run_detectors"]

_BROADCAST_MIN_BYTES = 64 * 1024

# ops an operand's value passes through unchanged in its elements
_PASS_THROUGH = frozenset({
    "contiguous", "clone", "view", "reshape", "_unsafe_view", "flatten",
    "unflatten", "squeeze", "unsqueeze"})
_BROADCASTS = frozenset({"broadcast_to", "expand", "expand_as"})


def _aten_name(node) -> Optional[str]:
    if node.op != "call_function":
        return None
    packet = getattr(node.target, "_overloadpacket", None)
    if packet is None or getattr(node.target, "namespace", None) != "aten":
        return None
    return packet.__name__


def _nbytes(node) -> int:
    val = node.meta.get("val")
    return val.numel() * val.element_size()


def _broadcast_source(node):
    """The broadcast node an operand node's value comes from, walking back
    through copies, views and reshapes; None when there is none."""
    while isinstance(node, torch.fx.Node):
        name = _aten_name(node)
        if name in _BROADCASTS:
            return node
        if name not in _PASS_THROUGH:
            return None
        node = node.args[0]
    return None


def detect_broadcast_operands(art: ProgramArtifacts) -> List[Finding]:
    findings = []
    for call in iter_kernel_calls(art.graph):
        for operand in call.args:
            if not (isinstance(operand, torch.fx.Node)
                    and isinstance(operand.meta.get("val"), torch.Tensor)):
                continue
            bcast = _broadcast_source(operand)
            if bcast is None:
                continue
            dst_b, src_b = _nbytes(operand), _nbytes(bcast.args[0])
            if dst_b < _BROADCAST_MIN_BYTES or dst_b <= src_b:
                continue  # small scales etc. — not the materialisation class
            findings.append(Finding(
                detector="broadcast-operand", severity="error",
                program=art.name, fingerprint=art.fingerprint,
                bytes=dst_b,
                where=f"{operand.name}->{NAMESPACE}::{op_name(call)}",
                message=(f"kernel operand {operand.name} is a materialised "
                         f"broadcast ({src_b} -> {dst_b} bytes, from "
                         f"{bcast.name}): a kernel reads it contiguous, so "
                         "this buffer hits device memory at full size on "
                         "every call (the lse residual class)"),
            ))
    return findings


DETECTORS: Dict[str, Callable[[ProgramArtifacts], List[Finding]]] = {
    "broadcast-operand": detect_broadcast_operands,
    # kernel-interior tier (analysis/kernels.py)
    "shared-memory-overflow": detect_shared_memory_overflow,
}


def run_detectors(art: ProgramArtifacts,
                  detectors: Optional[Sequence[str]] = None
                  ) -> List[Finding]:
    """Run the named detectors (default: all, in registry order) over one
    captured program."""
    names = list(detectors) if detectors else list(DETECTORS)
    out: List[Finding] = []
    for n in names:
        out.extend(DETECTORS[n](art))
    return out
