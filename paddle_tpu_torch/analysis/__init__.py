"""The port's program linter, kernel tier: capture a program without
running it and flag the hazards its kernel launches carry, with no card.

    from paddle_tpu_torch import analysis

    art = analysis.capture_fn(fn, analysis.TensorSpec((512, 128)), ...)
    for f in analysis.run_detectors(art):
        print(f.format())

``capture_fn`` exports the program with ``torch.export`` on meta tensors;
the port's kernels are custom ops, so each launch is one graph node with
its operands' shapes.  Two detectors: ``broadcast-operand`` (a kernel
operand materialised from a broadcast) and ``shared-memory-overflow`` (a
launch whose block asks for more shared memory than an H100 gives one
block, priced by the kernel module's own sizing function).  The known-bad
corpus (``analysis.corpus``) holds one program for each, and
``run_corpus_program`` runs them on the card.

This package is not imported by ``paddle_tpu_torch``: importing it loads
``torch.export``.
"""

from .findings import Finding, SEVERITIES, sort_findings  # noqa: F401
from .capture import ProgramArtifacts, TensorSpec, capture_fn  # noqa: F401
from .detectors import DETECTORS, run_detectors  # noqa: F401
from .kernels import (  # noqa: F401
    H100_SMEM_PER_BLOCK_OPTIN,
    kernel_cost,
    kernel_smem_bytes,
)
from . import kernels  # noqa: F401

__all__ = [
    "DETECTORS",
    "Finding",
    "H100_SMEM_PER_BLOCK_OPTIN",
    "ProgramArtifacts",
    "SEVERITIES",
    "TensorSpec",
    "capture_fn",
    "kernel_cost",
    "kernel_smem_bytes",
    "run_detectors",
    "sort_findings",
]
