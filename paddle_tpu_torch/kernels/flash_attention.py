"""Flash attention forward for the port (counterpart of
paddle_tpu/kernels/flash_attention.py, inference variant).

``flash_attention(q, k, v, causal, scale, k_lengths)`` on [B, H, S, D]
fp32 tensors:

- on a CUDA tensor it launches the hand-written kernel
  ``csrc/flash_fwd.cu`` (built at first use by ``_build``) or raises —
  there is no fallback to the plain version;
- on a CPU tensor it computes :func:`reference_attention`, the plain
  PyTorch version, which copies the JAX ``_reference_attention``
  contract: k_lengths key padding, bottom-right causal alignment
  ``tril(diagonal=Sk-Sq)``, and fully masked rows return zeros.

``flash_attention.launches`` counts kernel launches (CPU calls do not
count); ``chip_smoke.py`` reads it to show the serving path went
through the kernel.  The backward kernels (``_flash_bwd_dq_kernel``,
``_flash_bwd_dkv_kernel``) and the lse output belong to the training
slice and are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "reference_attention"]

NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535


def _lengths(k_lengths, batch: int, seq_k: int, device) -> torch.Tensor:
    if k_lengths is None:
        return torch.full((batch,), seq_k, dtype=torch.int32, device=device)
    kl = torch.as_tensor(k_lengths, device=device).to(torch.int32).reshape(-1)
    if kl.shape[0] != batch:
        raise ValueError(f"k_lengths has {kl.shape[0]} rows for batch {batch}")
    return kl


def reference_attention(q, k, v, causal: bool, scale: float,
                        k_lengths=None) -> torch.Tensor:
    """Plain PyTorch attention.  q [B, H, Sq, D], k/v [B, H, Sk, D],
    k_lengths [B] valid key counts (None: all Sk)."""
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    sq, sk = scores.shape[-2], scores.shape[-1]
    if k_lengths is not None:
        kl = _lengths(k_lengths, q.shape[0], sk, q.device)
        kmask = torch.arange(sk, device=q.device)[None, :] < kl[:, None]
        scores = scores.masked_fill(~kmask[:, None, None, :], NEG_INF)
    if causal:
        # bottom-right alignment, as jnp.tril(k=Sk-Sq): with cached keys
        # (Sk > Sq) query row i sees keys up to i + Sk - Sq
        cmask = torch.ones(sq, sk, dtype=torch.bool,
                           device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~cmask, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    # fully masked rows (padded queries) produce zeros, not uniform weights
    all_masked = scores.amax(dim=-1, keepdim=True) <= NEG_INF / 2
    weights = weights.masked_fill(all_masked, 0.0)
    return torch.matmul(weights, v)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_fwd").flash_fwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_fwd takes float32, {name} is {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd supports head_dim {_HEAD_DIMS}, got {D}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit {_MAX_GRID_Y}")


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    k_lengths=None) -> torch.Tensor:
    """q/k/v [B, H, S, D]; k_lengths optional [B] valid key counts.
    CUDA tensors launch ``flash_fwd``; CPU tensors take
    :func:`reference_attention`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal, scale,
                                   k_lengths=k_lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    klen = _lengths(k_lengths, B, Sk, q.device).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       klen.data_ptr(), out.data_ptr(), B, H, Sq, Sk, D,
                       float(scale), int(bool(causal)),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
