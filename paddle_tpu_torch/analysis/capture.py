"""Capture one port program for the linter without running it (counterpart
of paddle_tpu/analysis/capture.py ``capture_fn`` and ``ProgramArtifacts``).

``capture_fn(fn, *specs)`` exports ``fn`` with ``torch.export`` on meta
tensors: only shapes and dtypes enter, no kernel runs and no input is
allocated.  The port's kernels are custom ops
(``paddle_tpu_torch::corpus_add``, ...) whose fake implementations give
the output shapes, so each appears in the graph as one ``call_function``
node with its operands' shapes in ``node.meta["val"]``.  The export is
non-strict (no dynamo): the program is traced by running its Python.

The reference's jaxpr, StableHLO, HLO and cost views have no counterpart:
the port's graph is the exported ATen graph, and its times come from the
card, not from a compiler's cost model.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch
import torch.export

__all__ = ["ProgramArtifacts", "TensorSpec", "capture_fn"]


@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one program input."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32

    def meta(self) -> torch.Tensor:
        return torch.empty(tuple(self.shape), dtype=self.dtype,
                           device="meta")


@dataclass
class ProgramArtifacts:
    """One captured program: ``exported`` (the ExportedProgram), its
    ``graph`` (torch.fx Graph of ATen ops and the port's kernel ops) and
    ``fingerprint``, the first 12 hex digits of the sha1 of the graph
    module's code."""

    name: str
    exported: Any
    graph: torch.fx.Graph
    fingerprint: str


class _Program(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _meta(spec) -> torch.Tensor:
    if isinstance(spec, TensorSpec):
        return spec.meta()
    if isinstance(spec, torch.Tensor):
        return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    raise TypeError(f"capture_fn takes TensorSpecs or tensors (only their "
                    f"shape and dtype are used), got {type(spec).__name__}")


def capture_fn(fn, *specs: Sequence, name: str = "fn") -> ProgramArtifacts:
    """Export ``fn(*inputs)`` over meta tensors of the specs' shapes and
    dtypes (a TensorSpec, or a tensor whose shape and dtype are taken) and
    return its artifacts.  ``fn`` is a callable or an ``nn.Module``."""
    module = fn if isinstance(fn, torch.nn.Module) else _Program(fn)
    exported = torch.export.export(
        module, tuple(_meta(s) for s in specs), strict=False)
    gm = exported.graph_module
    return ProgramArtifacts(
        name=name, exported=exported, graph=gm.graph,
        fingerprint=hashlib.sha1(gm.code.encode()).hexdigest()[:12])
