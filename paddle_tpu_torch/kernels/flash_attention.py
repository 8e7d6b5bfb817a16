"""Flash attention for the port, forward and backward (counterpart of
paddle_tpu/kernels/flash_attention.py).

``flash_attention(q, k, v, causal, scale, k_lengths)`` on [B, H, S, D]
tensors, all fp32 or all bf16, is differentiable:

- on a CUDA tensor the forward launches ``csrc/flash_fwd.cu`` and, when a
  gradient is wanted, the backward launches the two kernels of
  ``csrc/flash_bwd.cu`` (dQ; dK and dV), the entry of the tensors'
  dtype (``*_f32`` or ``*_bf16``) — all built at first use by ``_build``
  — or raises: there is no fallback to the plain versions;
- on a CPU tensor the forward and backward are the plain PyTorch
  versions below, which copy the JAX ``_reference_attention`` contract:
  k_lengths key padding, bottom-right causal alignment
  ``tril(diagonal=Sk-Sq)``, and fully masked rows return zeros.

Any other dtype (fp16, fp64) or a mix of dtypes raises TypeError.  In
bf16 the math is fp32 and rounds where the TPU kernels round
(``paddle_tpu/kernels/flash_attention.py``): P to V's dtype before the PV
product, against a running max that moves once per 128-key tile from key
0, the TPU kernel's ``min(128, Sk)`` key block (:343, :353-354, :169-174;
``BLOCK_K``); dS to K's dtype before dS K (:227), dS^T to Q's before
dS^T Q (:267), P^T to dO's before P^T dO (:270); each output once (:181,
:232, :275-276).  lse and D stay fp32.
The bf16 plain versions (:func:`flash_attention_fwd_bf16_reference`,
and :func:`flash_attention_bwd_reference`, whose roundings are no-ops in
fp32) round at the same points, so a kernel and its plain version differ
only where fp32 summation order moves a value across a bf16 rounding
boundary.  The fp32 kernels, forward and backward, run their products on
the tensor cores as three TF32 products of split operands
(csrc/tf32_split.cuh), which keeps them within fp32's gate of the plain
versions; only the order of the fp32 sums moves.

As in the JAX module, the forward writes the per-row logsumexp (lse)
only when a backward will read it: a call with no input that requires a
gradient (serving's prefill) takes the fwd-only kernel variant.  The
backward rebuilds P = exp(S - lse) instead of storing it, and D =
rowsum(dO * O) is a plain torch reduction outside the kernels, as the
JAX package computes it outside Pallas.

Each kernel wrapper counts its launches (CPU calls do not count):
``flash_attention.launches`` (flash_fwd), ``flash_bwd_dq.launches`` and
``flash_bwd_dkv.launches``, and by entry dtype in ``.launches_by_dtype``
(``"float32"``, ``"bfloat16"``); ``reset_launches()`` zeroes them.
``chip_smoke.py`` reads them to show the serving and training paths went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

__all__ = ["BLOCK_K", "DTYPES", "NEG_INF", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_fwd_bf16_reference",
           "flash_attention_fwd_reference", "flash_bwd_dkv", "flash_bwd_dq",
           "reference_attention", "reset_launches"]

NEG_INF = -1e30
# the bf16 forward's key tile, the TPU kernel's key block: the running max,
# and with it the point where bf16 rounds P, moves once per tile
BLOCK_K = 128
# element dtype -> C entry suffix
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
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


def flash_attention_fwd_bf16_reference(q, k, v, causal: bool,
                                       scale: float, k_lengths=None,
                                       block_k: int = BLOCK_K):
    """Plain version of the bf16 forward with lse: (out [B, H, Sq, D] in
    q's dtype, lse [B, H, Sq] fp32).  fp32 math over key tiles of
    ``block_k`` with the kernel's online softmax: the running max starts
    at NEG_INF/2, P = exp(S - m) is rounded to V's dtype for the PV
    product while the row sum takes it unrounded, and the output rounds
    once.  The tile fixes where P rounds: ``block_k`` = BLOCK_K (128,
    one tile when Sk is smaller) is the TPU kernel's and the CUDA
    kernel's; any other value moves the rounding points."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s_all = _masked_scores(qf, kf, causal, scale, k_lengths)
    m = torch.full(s_all.shape[:-1] + (1,), NEG_INF / 2,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, s_all.shape[-1], block_k):
        s = s_all[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                        vf[..., k0:k0 + block_k, :])
        m = m_new
    denom = l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(denom),
                      torch.full_like(m, -NEG_INF))
    return (acc / denom).to(q.dtype), lse.squeeze(-1)


def flash_attention_bwd_reference(q, k, v, k_lengths, out, lse, dout,
                                  causal: bool, scale: float):
    """Plain version of the backward, the explicit FlashAttention-2
    formula the kernels compute: P = exp(S - lse) on visible entries (0
    elsewhere), D = rowsum(dO * O), dS = P * (dO V^T - D) * scale;
    returns (dQ = dS K, dK = dS^T Q, dV = P^T dO) in the dtypes of q, k
    and v.  The math is fp32; the product operands round where the bf16
    kernels round (dS to K's dtype, dS^T to Q's, P^T to dO's), which is
    the identity for fp32 inputs."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = _visible(q.shape[0], s.shape[-2], s.shape[-1], causal, k_lengths,
                   q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dvec = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - dvec) * scale
    dst = ds.transpose(-1, -2)
    return (torch.matmul(ds.to(k.dtype).float(), kf).to(q.dtype),
            torch.matmul(dst.to(q.dtype).float(), qf).to(k.dtype),
            torch.matmul(p.transpose(-1, -2).to(dout.dtype).float(),
                         dof).to(v.dtype))


# -- CUDA entries -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype):
    """The C entry ``<kernel>_f32`` or ``<kernel>_bf16`` for ``dtype``."""
    lib = "flash_fwd" if kernel == "flash_fwd" else "flash_bwd"
    fn = getattr(_build.library(lib), f"{kernel}_{DTYPES[dtype]}")
    ptrs = {"flash_fwd": 6, "flash_bwd_dq": 8, "flash_bwd_dkv": 9}[kernel]
    fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _dtype_of(kernel, **named) -> torch.dtype:
    """The one element dtype of ``named`` (q, k, v and dout): float32 or
    bfloat16; any other dtype, or a mix, raises TypeError."""
    dtypes = {name: t.dtype for name, t in named.items()}
    dtype = dtypes["q"]
    if dtype not in DTYPES:
        raise TypeError(f"{kernel} takes float32 or bfloat16, q is {dtype}")
    mixed = {n: d for n, d in dtypes.items() if d != dtype}
    if mixed:
        raise TypeError(f"{kernel} takes one dtype: q is {dtype}, "
                        + ", ".join(f"{n} is {d}" for n, d in mixed.items()))
    return dtype


def _check(kernel, q, k, v, **more) -> None:
    named = dict(q=q, k=k, v=v, **more)
    _dtype_of(kernel, **{n: t for n, t in named.items()
                         if n not in ("lse", "dvec")})
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if name in ("lse", "dvec") and t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes a float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernels load 16 (fp32) or 8 (bf16) bytes
            raise ValueError(f"{name} must be 16-byte aligned")
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


def _count(wrapper, dtype: torch.dtype) -> None:
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dtype).removeprefix("torch.")] += 1


def flash_attention_fwd(q, k, v, causal: bool, scale: float, k_lengths=None,
                        need_lse: bool = True):
    """(out, lse or None).  CUDA tensors launch ``flash_fwd`` of their
    dtype (with the lse output only when ``need_lse``); CPU tensors take
    the plain versions."""
    if not _on_cuda(q):
        if _dtype_of("flash_fwd", q=q, k=k, v=v) == torch.bfloat16:
            out, lse = flash_attention_fwd_bf16_reference(
                q, k, v, causal, scale, k_lengths)
            return out, lse if need_lse else None
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
        err = _entry("flash_fwd", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), klen.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    _count(flash_attention, q.dtype)
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
        err = _entry("flash_bwd_dq", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), klen.data_ptr(), dq.data_ptr(),
            B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dq")
    _count(flash_bwd_dq, q.dtype)
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
        err = _entry("flash_bwd_dkv", q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), klen.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Sq, Sk, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd_dkv")
    _count(flash_bwd_dkv, q.dtype)
    return dk, dv


def flash_attention_bwd(q, k, v, k_lengths, out, lse, dout, causal: bool,
                        scale: float):
    """(dQ, dK, dV).  CUDA tensors launch ``flash_bwd_dq`` and
    ``flash_bwd_dkv``; CPU tensors take
    :func:`flash_attention_bwd_reference`."""
    if not _on_cuda(q):
        _dtype_of("flash_attention_bwd", q=q, k=k, v=v, dout=dout)
        return flash_attention_bwd_reference(q, k, v, k_lengths, out, lse,
                                             dout, causal, scale)
    # D = rowsum(dO * O), [B, H, Sq], fp32 for any operand dtype
    dvec = (dout.float() * out.float()).sum(dim=-1)
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


def reset_launches() -> None:
    """Zero the three wrappers' launch counts (total and by dtype)."""
    for wrapper in (flash_attention, flash_bwd_dq, flash_bwd_dkv):
        wrapper.launches = 0
        wrapper.launches_by_dtype = {str(d).removeprefix("torch."): 0
                                     for d in DTYPES}


reset_launches()
