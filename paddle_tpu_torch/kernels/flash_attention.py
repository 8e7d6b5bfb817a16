"""Flash attention for the port, forward and backward (counterpart of
paddle_tpu/kernels/flash_attention.py).

``flash_attention(q, k, v, causal, scale, k_lengths)`` on [B, H, S, D]
fp32 tensors is differentiable:

- on a CUDA tensor the forward launches ``csrc/flash_fwd.cu`` and, when a
  gradient is wanted, the backward launches the two kernels of
  ``csrc/flash_bwd.cu`` (dQ; dK and dV) — all built at first use by
  ``_build`` — or raises: there is no fallback to the plain versions;
- on a CPU tensor the forward and backward are the plain PyTorch
  versions below, which copy the JAX ``_reference_attention`` contract:
  k_lengths key padding, bottom-right causal alignment
  ``tril(diagonal=Sk-Sq)``, and fully masked rows return zeros.

As in the JAX module, the forward writes the per-row logsumexp (lse)
only when a backward will read it: a call with no input that requires a
gradient (serving's prefill) takes the fwd-only kernel variant.  The
backward rebuilds P = exp(S - lse) instead of storing it, and D =
rowsum(dO * O) is a plain torch reduction outside the kernels, as the
JAX package computes it outside Pallas.

Each kernel wrapper counts its launches (CPU calls do not count):
``flash_attention.launches`` (flash_fwd), ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches``.  ``chip_smoke.py`` reads them to show the
serving and training paths went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["NEG_INF", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_fwd",
           "flash_attention_fwd_reference", "flash_bwd_dkv", "flash_bwd_dq",
           "reference_attention"]

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


def _visible(batch: int, sq: int, sk: int, causal: bool, k_lengths,
             device) -> torch.Tensor:
    """[B, 1, Sq, Sk] bool: key j visible to query i of batch row b."""
    kl = _lengths(k_lengths, batch, sk, device)
    vis = (torch.arange(sk, device=device)[None, :]
           < kl[:, None])[:, None, None, :]
    if causal:
        # bottom-right alignment, as jnp.tril(k=Sk-Sq): with cached keys
        # (Sk > Sq) query row i sees keys up to i + Sk - Sq
        vis = vis & torch.ones(sq, sk, dtype=torch.bool,
                               device=device).tril(diagonal=sk - sq)
    return vis


def _masked_scores(q, k, causal, scale, k_lengths):
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    vis = _visible(q.shape[0], scores.shape[-2], scores.shape[-1], causal,
                   k_lengths, q.device)
    return scores.masked_fill(~vis, NEG_INF)


def reference_attention(q, k, v, causal: bool, scale: float,
                        k_lengths=None) -> torch.Tensor:
    """Plain PyTorch attention.  q [B, H, Sq, D], k/v [B, H, Sk, D],
    k_lengths [B] valid key counts (None: all Sk)."""
    scores = _masked_scores(q, k, causal, scale, k_lengths)
    weights = torch.softmax(scores, dim=-1)
    # fully masked rows (padded queries) produce zeros, not uniform weights
    all_masked = scores.amax(dim=-1, keepdim=True) <= NEG_INF / 2
    weights = weights.masked_fill(all_masked, 0.0)
    return torch.matmul(weights, v)


def flash_attention_fwd_reference(q, k, v, causal: bool, scale: float,
                                  k_lengths=None):
    """Plain version of the forward with lse: (out [B, H, Sq, D], lse
    [B, H, Sq] fp32).  A fully masked row has lse = -NEG_INF (+1e30), as
    the TPU kernel writes it, so exp(S - lse) is 0 there."""
    scores = _masked_scores(q, k, causal, scale, k_lengths)
    all_masked = scores.amax(dim=-1) <= NEG_INF / 2
    lse = torch.logsumexp(scores, dim=-1).masked_fill(all_masked, -NEG_INF)
    weights = torch.softmax(scores, dim=-1).masked_fill(
        all_masked[..., None], 0.0)
    return torch.matmul(weights, v), lse


def flash_attention_bwd_reference(q, k, v, k_lengths, out, lse, dout,
                                  causal: bool, scale: float):
    """Plain version of the backward, the explicit FlashAttention-2
    formula the kernels compute: P = exp(S - lse) on visible entries (0
    elsewhere), D = rowsum(dO * O), dS = P * (dO V^T - D) * scale;
    returns (dQ = dS K, dK = dS^T Q, dV = P^T dO)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    vis = _visible(q.shape[0], s.shape[-2], s.shape[-1], causal, k_lengths,
                   q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dvec = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dout, v.transpose(-1, -2)) - dvec) * scale
    return (torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q),
            torch.matmul(p.transpose(-1, -2), dout))


# -- CUDA entries -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = "flash_fwd" if name == "flash_fwd_f32" else "flash_bwd"
    fn = getattr(_build.library(lib), name)
    ptrs = {"flash_fwd_f32": 6, "flash_bwd_dq_f32": 8,
            "flash_bwd_dkv_f32": 9}[name]
    fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(kernel, q, k, v, **more) -> None:
    named = dict(q=q, k=k, v=v, **more)
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k", "v"):
        if named[name].dim() != 4:
            raise ValueError(f"{name} must be [B, H, S, D], got "
                             f"{tuple(named[name].shape)}")
    B, H, Sq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if "dout" in named and named["dout"].shape != q.shape:
        raise ValueError(f"dout {tuple(named['dout'].shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    for name in ("lse", "dvec"):
        if name in named and named[name].shape != (B, H, Sq):
            raise ValueError(f"{name} must be [B, H, Sq] = {(B, H, Sq)}, "
                             f"got {tuple(named[name].shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{kernel} supports head_dim {_HEAD_DIMS}, got {D}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B*H = {B * H} exceeds the grid limit {_MAX_GRID_Y}")


def _on_cuda(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return True


def flash_attention_fwd(q, k, v, causal: bool, scale: float, k_lengths=None,
                        need_lse: bool = True):
    """(out, lse or None).  CUDA tensors launch ``flash_fwd`` (with the lse
    output only when ``need_lse``); CPU tensors take the plain versions."""
    if not _on_cuda(q):
        if need_lse:
            return flash_attention_fwd_reference(q, k, v, causal, scale,
                                                 k_lengths)
        return reference_attention(q, k, v, causal, scale,
                                   k_lengths=k_lengths), None
    _check("flash_fwd", q, k, v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    klen = _lengths(k_lengths, B, Sk, q.device).contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = _entry("flash_fwd_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), klen.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, dvec, k_lengths, causal: bool,
                 scale: float) -> torch.Tensor:
    """dQ from the ``flash_bwd_dq`` kernel (CUDA tensors only)."""
    _check("flash_bwd_dq", q, k, v, dout=dout, lse=lse, dvec=dvec)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    klen = _lengths(k_lengths, B, Sk, q.device).contiguous()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry("flash_bwd_dq_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), klen.data_ptr(), dq.data_ptr(),
            B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dvec, k_lengths, causal: bool,
                  scale: float):
    """(dK, dV) from the ``flash_bwd_dkv`` kernel (CUDA tensors only)."""
    _check("flash_bwd_dkv", q, k, v, dout=dout, lse=lse, dvec=dvec)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    klen = _lengths(k_lengths, B, Sk, q.device).contiguous()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _entry("flash_bwd_dkv_f32")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), klen.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, k_lengths, out, lse, dout, causal: bool,
                        scale: float):
    """(dQ, dK, dV).  CUDA tensors launch ``flash_bwd_dq`` and
    ``flash_bwd_dkv``; CPU tensors take
    :func:`flash_attention_bwd_reference`."""
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, k_lengths, out, lse,
                                             dout, causal, scale)
    dvec = (dout * out).sum(dim=-1)  # D = rowsum(dO * O), [B, H, Sq]
    dq = flash_bwd_dq(q, k, v, dout, lse, dvec, k_lengths, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, dvec, k_lengths, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX module's custom_vjp ``_flash``."""

    @staticmethod
    def forward(ctx, q, k, v, k_lengths, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal, scale, k_lengths)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.k_lengths, ctx.causal, ctx.scale = k_lengths, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, ctx.k_lengths, out, lse,
                                         dout.contiguous(), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    k_lengths=None) -> torch.Tensor:
    """q/k/v [B, H, S, D]; k_lengths optional [B] valid key counts.
    CUDA tensors launch the kernels; CPU tensors take the plain versions.
    Differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, k_lengths, bool(causal),
                                     float(scale))
    return flash_attention_fwd(q, k, v, causal, scale, k_lengths,
                               need_lse=False)[0]


flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
