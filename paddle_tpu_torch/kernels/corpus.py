"""The two kernels of the program linter's known-bad corpus (counterparts of
the pallas_calls in paddle_tpu/analysis/corpus.py), as custom ops.

- ``corpus_add(x, b)`` is out = x + b over two fp32 tensors of one shape
  (row 8: ``_broadcast_lse_operand``'s ``_add_kernel``, corpus.py:37);
- ``corpus_scale(x, tile_rows)`` is out = 2 * x over fp32 x [n_blocks,
  rows, cols] through a shared-memory buffer of ``tile_rows`` rows, at
  most one block an SM, each walking its tiles (row 9:
  ``_vmem_overflow``'s ``_scale_kernel``, corpus.py:177, whose BlockSpec
  holds a whole [4096, 4096] block in VMEM).

Both are registered with ``torch.library.custom_op`` as
``paddle_tpu_torch::corpus_add`` and ``paddle_tpu_torch::corpus_scale``,
each with a fake implementation that only makes an output of the right
shape, so ``torch.export`` captures a program that calls them on meta
tensors without running a kernel, and the graph names the op and its
arguments (``tile_rows`` stays a plain int).  The registration runs once,
when this module is first imported: do not reload it.

On a CUDA tensor each op launches its entry of ``csrc/corpus.cu`` (built
at first use by ``_build``) or raises :class:`_build.KernelLaunchError`
with the entry's cudaError_t in ``.code``; a refused launch is never
replaced by the plain version.  On a CPU tensor it takes the plain
version below.  ``corpus_scale`` asks for the dynamic shared memory that
:func:`corpus_scale_smem_bytes` gives, the number the linter's
shared-memory-overflow detector prices the same call with, so the two
cannot drift; past the card's per-block opt-in limit (232448 bytes on an
H100, :func:`smem_per_block_optin`) the launch is refused.

An operand that is not contiguous (a bare ``expand``) is copied to a
contiguous tensor before the launch, as XLA materialises a custom-call
operand: the kernels read contiguous memory.  ``corpus_add.launches`` and
``corpus_scale.launches`` count launches (CPU calls and refused launches
do not count); ``reset_launches()`` zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from . import _build

__all__ = ["H100_SMS", "corpus_add", "corpus_add_grid",
           "corpus_add_reference", "corpus_scale", "corpus_scale_grid",
           "corpus_scale_reference", "corpus_scale_smem_bytes",
           "reset_launches", "smem_per_block_optin"]

ADD_THREADS = 256     # csrc/corpus.cu ADD_THREADS
H100_SMS = 132        # streaming multiprocessors of an H100 SXM


# -- sizing, shared with the linter's pricing ---------------------------------

def corpus_add_grid(numel: int):
    """The grid ``corpus_add_f32`` launches over ``numel`` elements of
    16-byte aligned operands: one thread a float4 when numel is a multiple
    of 4, else one a float, ADD_THREADS a block."""
    units = numel // 4 if numel % 4 == 0 else numel
    return (-(-units // ADD_THREADS),)


def corpus_scale_grid(shape: Sequence[int], tile_rows: int,
                      sms: int = H100_SMS):
    """(n_blocks, grid_y): grid_y blocks a matrix, as many as its tiles
    (ceil(rows / tile_rows)) but no more than sms // n_blocks (at least
    one), so the grid holds at most one block an SM unless the matrices
    alone outnumber the SMs (``sms``: the card's streaming
    multiprocessors, an H100's by default, as the linter prices); block
    (x, y) walks tiles y, y + grid_y, ... of matrix x."""
    n_blocks, rows, _ = _scale_dims(shape)
    tiles = -(-rows // int(tile_rows))
    return (n_blocks, min(tiles, max(1, int(sms) // max(n_blocks, 1))))


def corpus_scale_smem_bytes(shape: Sequence[int], dtype,
                            tile_rows: int) -> int:
    """Dynamic shared memory one block of ``corpus_scale`` asks for over x
    of ``shape`` and ``dtype``: a tile of tile_rows x cols elements, the
    counterpart of the TPU kernel's VMEM block.  The wrapper requests
    exactly this much, and the linter prices the launch with it."""
    _, _, cols = _scale_dims(shape)
    if int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    return int(tile_rows) * cols * dtype.itemsize


def _scale_dims(shape):
    if len(shape) != 3:
        raise ValueError(f"corpus_scale takes x [n_blocks, rows, cols], got "
                         f"shape {tuple(shape)}")
    return tuple(int(d) for d in shape)


# -- plain versions ----------------------------------------------------------

def corpus_add_reference(x, b):
    """Plain version of ``corpus_add``: x + b."""
    return x + b


def corpus_scale_reference(x):
    """Plain version of ``corpus_scale`` (the tile changes where the data
    passes, not the result): 2 * x."""
    return x * 2


# -- CUDA entries ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.library("corpus"), name)
    fn.argtypes = {
        "corpus_add_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                    ctypes.c_void_p],
        "corpus_scale_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_longlong, ctypes.c_void_p],
        "corpus_smem_optin": [ctypes.POINTER(ctypes.c_int)],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(kernel: str, **named) -> bool:
    """True on CUDA tensors, False on CPU ones; every tensor float32 and on
    one device."""
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: tensors on " + ", ".join(
            f"{n} {t.device}" for n, t in named.items()))
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32, {name} is {t.dtype}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel} runs on cuda or cpu, not {device}")
    return device.type == "cuda"


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@torch.library.custom_op("paddle_tpu_torch::corpus_add", mutates_args=())
def corpus_add(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x + b over two float32 tensors of one shape: ``corpus_add_f32`` on
    CUDA tensors, :func:`corpus_add_reference` on CPU ones."""
    if b.shape != x.shape:
        raise ValueError(f"corpus_add: b {tuple(b.shape)} is not x's shape "
                         f"{tuple(x.shape)}")
    if not _on_cuda("corpus_add", x=x, b=b):
        return corpus_add_reference(x, b)
    x, b = x.contiguous(), b.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _entry("corpus_add_f32")(x.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), x.numel(), _stream(x))
    _build.check(err, "corpus_add")
    corpus_add.launches += 1
    return out


@corpus_add.register_fake
def _corpus_add_fake(x, b):
    return x.new_empty(x.shape)


@torch.library.custom_op("paddle_tpu_torch::corpus_scale", mutates_args=())
def corpus_scale(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """2 * x over float32 x [n_blocks, rows, cols] through a buffer of
    tile_rows x cols in shared memory: ``corpus_scale_f32`` on CUDA
    tensors over :func:`corpus_scale_grid` for the card's SM count
    (refused past the card's shared memory),
    :func:`corpus_scale_reference` on CPU ones."""
    smem = corpus_scale_smem_bytes(x.shape, x.dtype, tile_rows)
    if not _on_cuda("corpus_scale", x=x):
        return corpus_scale_reference(x)
    n_blocks, rows, cols = _scale_dims(x.shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, grid_y = corpus_scale_grid(x.shape, tile_rows, sms)
    with torch.cuda.device(x.device):
        err = _entry("corpus_scale_f32")(
            x.data_ptr(), out.data_ptr(), n_blocks, rows, cols,
            int(tile_rows), grid_y, smem, _stream(x))
    _build.check(err, f"corpus_scale (tile_rows {tile_rows}: {smem} bytes "
                      "of shared memory a block)")
    corpus_scale.launches += 1
    return out


@corpus_scale.register_fake
def _corpus_scale_fake(x, tile_rows):
    corpus_scale_smem_bytes(x.shape, x.dtype, tile_rows)
    return x.new_empty(x.shape)


def smem_per_block_optin(device=None) -> int:
    """The card's own cudaDevAttrMaxSharedMemoryPerBlockOptin: the most
    dynamic shared memory one block may ask for."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device or torch.cuda.current_device()):
        err = _entry("corpus_smem_optin")(ctypes.byref(out))
    _build.check(err, "corpus_smem_optin")
    return out.value


def reset_launches() -> None:
    """Zero both ops' launch counts."""
    corpus_add.launches = 0
    corpus_scale.launches = 0


reset_launches()
