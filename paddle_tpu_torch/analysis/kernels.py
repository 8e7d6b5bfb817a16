"""Kernel-interior analysis: price a port kernel's shared memory from the
captured graph, with no compile and no card (counterpart of
paddle_tpu/analysis/pallas.py).

Every kernel of the port that the linter can see is a custom op in the
``paddle_tpu_torch`` namespace, so a captured program shows each launch as
one ``call_function`` node whose arguments carry their shapes and dtypes
(``node.meta["val"]``) and its plain ints (a tile size).  The kernel
module's own sizing function prices the node: the wrapper asks the card
for exactly the shared memory that function gives, so the linter's price
and the launch cannot drift.  A Hopper block may ask for at most 232448
bytes of shared memory (227 KiB, the opt-in limit of an H100, Hopper's
counterpart of a v5e core's 16 MiB of VMEM); past it the launch is
refused, which ``detect_shared_memory_overflow`` reports before any run.

Only the corpus ops are priced so far (``corpus_add`` uses no shared
memory).  A port kernel op with no pricing is reported as unpriced, never
priced as 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import torch

from ..kernels import corpus as corpus_kernels
from .findings import Finding

__all__ = [
    "H100_SMEM_PER_BLOCK_OPTIN",
    "KernelCost",
    "UnpricedKernelError",
    "default_smem_budget",
    "detect_shared_memory_overflow",
    "iter_kernel_calls",
    "kernel_cost",
    "kernel_smem_bytes",
]

# the most dynamic shared memory one block may ask for on an H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin; the hopper data sheet's 227 KB)
H100_SMEM_PER_BLOCK_OPTIN = 232448

NAMESPACE = "paddle_tpu_torch"


class UnpricedKernelError(LookupError):
    """A port kernel op the linter has no pricing function for."""


def default_smem_budget() -> int:
    """The shared-memory-overflow detector's budget: one H100 block's
    opt-in limit."""
    return H100_SMEM_PER_BLOCK_OPTIN


@dataclass
class KernelCost:
    """The statically priced on-chip working set of one kernel launch.

    buffers: (role, shape, dtype, shared-memory bytes) per operand; role
    'in' / 'out' for an operand, 'tile' for a staged tile."""

    name: str
    grid: Tuple[int, ...]
    smem_bytes: int
    buffers: List[Tuple[str, Tuple[int, ...], str, int]] = field(
        default_factory=list)


def iter_kernel_calls(graph) -> Iterator[torch.fx.Node]:
    """Every ``call_function`` node of a Graph (or GraphModule) whose target
    is an op of the port's namespace."""
    graph = getattr(graph, "graph", graph)
    for node in graph.nodes:
        if (node.op == "call_function"
                and getattr(node.target, "namespace", None) == NAMESPACE):
            yield node


def op_name(node) -> str:
    """``corpus_add`` for the node of ``paddle_tpu_torch::corpus_add``."""
    return node.target._schema.name.split("::", 1)[1]


def bound_args(node) -> dict:
    """The node's arguments by schema name: a tensor operand as its
    ``meta["val"]`` (shape and dtype, no data), a constant as itself."""
    names = [arg.name for arg in node.target._schema.arguments]
    args = dict(zip(names, node.args), **node.kwargs)
    return {k: v.meta["val"] if isinstance(v, torch.fx.Node) else v
            for k, v in args.items()}


def _dt(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _price_corpus_add(x, b) -> KernelCost:
    return KernelCost(
        "corpus_add", corpus_kernels.corpus_add_grid(x.numel()), 0,
        [("in", tuple(x.shape), _dt(x), 0), ("in", tuple(b.shape), _dt(b), 0),
         ("out", tuple(x.shape), _dt(x), 0)])


def _price_corpus_scale(x, tile_rows) -> KernelCost:
    smem = corpus_kernels.corpus_scale_smem_bytes(x.shape, x.dtype,
                                                  tile_rows)
    return KernelCost(
        "corpus_scale", corpus_kernels.corpus_scale_grid(x.shape, tile_rows),
        smem, [("in", tuple(x.shape), _dt(x), 0),
               ("tile", (int(tile_rows), int(x.shape[2])), _dt(x), smem),
               ("out", tuple(x.shape), _dt(x), 0)])


# op name -> pricing function over the node's bound arguments
PRICING = {
    "corpus_add": _price_corpus_add,
    "corpus_scale": _price_corpus_scale,
}


def kernel_cost(node) -> KernelCost:
    """Price one port kernel node; :class:`UnpricedKernelError` for an op
    with no pricing function."""
    name = op_name(node)
    price = PRICING.get(name)
    if price is None:
        raise UnpricedKernelError(
            f"{NAMESPACE}::{name} has no shared-memory pricing")
    return price(**bound_args(node))


def kernel_smem_bytes(node) -> int:
    """The dynamic shared memory one block of this launch asks for."""
    return kernel_cost(node).smem_bytes


def detect_shared_memory_overflow(art, budget: Optional[int] = None
                                  ) -> List[Finding]:
    """Flag every port kernel node whose block asks for more shared memory
    than ``budget`` (default :func:`default_smem_budget`): the card refuses
    such a launch.  A kernel op with no pricing is reported as an ``info``
    finding, unchecked."""
    budget = default_smem_budget() if budget is None else int(budget)
    findings: List[Finding] = []
    for node in iter_kernel_calls(art.graph):
        where = f"{node.name}:{NAMESPACE}::{op_name(node)}"
        try:
            cost = kernel_cost(node)
        except UnpricedKernelError as e:
            findings.append(Finding(
                detector="shared-memory-overflow", severity="info",
                program=art.name, fingerprint=art.fingerprint, where=where,
                message=f"{e}: not checked against the budget"))
            continue
        if cost.smem_bytes <= budget:
            continue
        worst = ", ".join(
            f"{role} {dtype}{list(shape)}={b} B"
            for role, shape, dtype, b in cost.buffers if b)
        findings.append(Finding(
            detector="shared-memory-overflow", severity="error",
            program=art.name, fingerprint=art.fingerprint, where=where,
            smem_bytes=cost.smem_bytes, budget=budget,
            message=(f"kernel {cost.name} asks for {cost.smem_bytes} bytes "
                     f"of shared memory a block (budget {budget}): grid "
                     f"{cost.grid}, {worst}; the card refuses this launch — "
                     "tile finer")))
    return findings
