"""Known-bad corpus of the port's linter (counterpart of
paddle_tpu/analysis/corpus.py, the two programs that launch a kernel).

Each program re-creates one hazard class and calls one of the port's
kernels: the linter must flag its capture with the right detector, and
the card must run it through that kernel (``run_corpus_program``), so a
verdict can be held against what the card does.

- ``broadcast_lse``: an lse-shaped [512] vector broadcast to [512, 128]
  and made contiguous as an operand of ``corpus_add`` (x [512, 128] fp32)
  — the residual bug of the flash kernels' first version, which a fused
  broadcast would not have paid.  Flagged by ``broadcast-operand``
  (262144 bytes).
- ``vmem_overflow``: ``corpus_scale`` over x [2, 4096, 4096] fp32 with a
  tile of 4096 rows, the whole [4096, 4096] block the TPU kernel holds in
  VMEM: 64 MiB of shared memory a block against 232448.  Flagged by
  ``shared-memory-overflow``; the card refuses the launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.corpus import corpus_add, corpus_scale
from .capture import ProgramArtifacts, TensorSpec, capture_fn

__all__ = ["CORPUS", "build_corpus_program", "corpus_fn", "corpus_inputs",
           "run_corpus_program"]

_N = 4096  # one fp32 [N, N] block = 64 MiB


def _broadcast_lse_fn(x, lse):
    # the bug shape: per-row scalar state padded to the 128-lane width
    b = lse[:, None].expand(x.shape[0], 128).contiguous()
    return corpus_add(x, b)


def _vmem_overflow_fn(x):
    return corpus_scale(x, _N)


# name -> (plain callable, input specs)
_PROGRAMS = {
    "broadcast_lse": (_broadcast_lse_fn,
                      (TensorSpec((512, 128)), TensorSpec((512,)))),
    "vmem_overflow": (_vmem_overflow_fn, (TensorSpec((2, _N, _N)),)),
}


def _capture(name: str) -> ProgramArtifacts:
    fn, specs = _PROGRAMS[name]
    return capture_fn(fn, *specs, name=f"corpus_{name}")


def _broadcast_lse_operand() -> ProgramArtifacts:
    return _capture("broadcast_lse")


def _vmem_overflow() -> ProgramArtifacts:
    return _capture("vmem_overflow")


# name -> (builder, detector id the linter must flag it with)
CORPUS = {
    "broadcast_lse": (_broadcast_lse_operand, "broadcast-operand"),
    "vmem_overflow": (_vmem_overflow, "shared-memory-overflow"),
}


@functools.lru_cache(maxsize=None)
def build_corpus_program(name: str) -> ProgramArtifacts:
    """Capture (and memoize: corpus programs are immutable) one known-bad
    program by name."""
    builder, _expected = CORPUS[name]
    return builder()


def corpus_fn(name: str):
    """The program's plain callable, to run it."""
    return _PROGRAMS[name][0]


def corpus_inputs(name: str, seed: int = 0, device=None):
    """The program's inputs: float32 standard normals from a numpy
    generator seeded with ``seed``, on ``device`` (resolved as every entry
    point resolves it: the card by default)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(spec.shape,
                                                 dtype=np.float32)).to(dev)
            for spec in _PROGRAMS[name][1]]


def run_corpus_program(name: str, seed: int = 0, device=None):
    """Run one corpus program on :func:`corpus_inputs` and return its
    output.  ``device=None`` is the card (NoCudaDeviceError without one);
    the CPU runs the kernels' plain versions only when asked."""
    return corpus_fn(name)(*corpus_inputs(name, seed, device))
