"""Mixed-precision (AMP) policy (counterpart of paddle_tpu/core/amp.py):
matmul operands in bf16, fp32 everywhere else.

Params, optimizer state and the non-matmul math stay fp32 (master
weights).  Only the operands of the matmul rules are cast, and by default
the product is cast straight back to fp32.  Gradients flow through the
casts under ``torch.autograd.grad``, so the backward products run in the
half dtype too and the param grads come back fp32.

``enable_amp(dtype, keep_output=True)`` is the aggressive tier: matmul
outputs STAY bf16, so the elementwise chains between them read and write
half-width activations; normalization statistics and losses still
accumulate in fp32 (``stats_dtype``), and binary ops cast an fp32 operand
down rather than widen a half-width one (``match_kept``).  As in JAX,
fp16 tensors count as half-width there too.

The policy is process-wide, as in the JAX package, and explicit only:
with no ``enable_amp`` call the port computes in fp32 on every device.
(The JAX package picks keep-tier bf16 by itself when it traces for a TPU;
that default came from TPU measurements and is not carried over.)  The
eager executor compiles nothing, so there is no ``state_key``.
"""

from __future__ import annotations

import torch

__all__ = ["amp_dtype", "disable_amp", "enable_amp", "keep_output",
           "match_kept", "mxu_operands", "mxu_output", "reset_amp",
           "stats_dtype"]

_HALF = (torch.bfloat16, torch.float16)
_POLICY = {"dtype": None, "keep": False}


def enable_amp(dtype: str = "bfloat16", keep_output: bool = False) -> None:
    """Turn on mixed precision: matmul compute in bf16 (the one dtype the
    port's kernels take besides fp32); ``keep_output`` keeps matmul
    outputs in it."""
    if str(dtype) != "bfloat16":
        raise ValueError(f"enable_amp takes bfloat16, not {dtype!r}")
    _POLICY["dtype"] = torch.bfloat16
    _POLICY["keep"] = bool(keep_output)


def disable_amp() -> None:
    _POLICY["dtype"] = None
    _POLICY["keep"] = False


def reset_amp() -> None:
    """Back to the default, which in the port is fp32 (``disable_amp``)."""
    disable_amp()


def amp_dtype():
    """The compute dtype of the matmul rules, or None when AMP is off."""
    return _POLICY["dtype"]


def keep_output() -> bool:
    return _POLICY["keep"]


def stats_dtype(x) -> torch.dtype:
    """The dtype reductions (norm statistics, softmax, loss sums) take for
    activations of x's dtype: fp32 for a half-width input, x's otherwise."""
    return torch.float32 if x.dtype in _HALF else x.dtype


def match_kept(x, y):
    """In keep_output mode, a binary elementwise op over a half-width
    activation and an fp32 tensor (a bias add, the residual add) casts
    the fp32 side down instead of letting promotion re-widen the
    activation chain.  Outside keep mode the pair is returned as is."""
    if not _POLICY["keep"]:
        return x, y
    if x.dtype in _HALF and y.dtype == torch.float32:
        return x, y.to(x.dtype)
    if y.dtype in _HALF and x.dtype == torch.float32:
        return x.to(y.dtype), y
    return x, y


def mxu_operands(*tensors):
    """Cast fp32 matmul operands to the AMP dtype (no-op when AMP is off,
    and for non-fp32 operands)."""
    d = _POLICY["dtype"]
    if d is None:
        return tensors
    return tuple(t.to(d) if t.dtype == torch.float32 else t
                 for t in tensors)


def mxu_output(out, *orig_operands):
    """Cast a matmul result back to fp32 when AMP downcast one of its
    operands (``orig_operands``, the tensors before ``mxu_operands``),
    unless keep_output is on; a product of operands that were already
    half-width stays half-width."""
    d = _POLICY["dtype"]
    if d is None or out.dtype != d or _POLICY["keep"]:
        return out
    if any(t.dtype == torch.float32 for t in orig_operands):
        return out.to(torch.float32)
    return out
