"""Fused conv + batch-norm statistics, and the batch-norm epilogue, for the
port (counterpart of paddle_tpu/kernels/conv_epilogue.py).

Layout is the JAX module's: x [N, H, W, C] NHWC, w [K, K, C, F] (HWIO),
the conv output and y [N, Ho, Wo, F] NHWC; padding is fluid's explicit
symmetric int.  Two kernels of ``csrc/conv_epilogue.cu``, each with an
fp32 and a bf16 entry:

- ``conv_stats(x, w, stride, padding) -> (out, sum, sumsq)`` writes the
  conv output once and its per-channel sum and sum of squares (the TPU
  kernels at conv_epilogue.py:347 and :383 — one CUDA entry per dtype,
  since stride and padding are bounds checks on the card);
- ``bn_epilogue(out, mean, inv, gamma, beta, z, act) -> y`` is
  act((out - mean) * inv * gamma + beta [+ z]) in one pass (:412).

x, w, out, z and y share one dtype, float32 or bfloat16; sum, sumsq,
mean, inv, gamma and beta are float32.  In bf16 the kernels round where
the TPU kernels round, and only there: every product accumulates in fp32,
``out`` is stored rounded to bf16 while the sums take the unrounded fp32
values (conv_epilogue.py:129-148), and the epilogue runs in fp32 over the
widened ``out`` and z and rounds y once (:186-192).  The plain versions
below round at the same points, so a kernel and its plain version differ
only where fp32 summation order moves a value across a bf16 rounding
boundary.  (A composition that takes its statistics from the rounded
``out``, as :func:`conv_bn_act_reference` and the JAX module's reference
do, is another function.)

Between the kernels, as in the JAX module, mean = sum / count, var =
max(sumsq / count - mean^2, 0) (one pass, the TPU kernel's formula) and
inv = rsqrt(var + eps) are [F] fp32 torch ops.

On a CUDA tensor each wrapper launches the entry of its dtype (built at
first use by ``_build``) or raises; any other dtype, or a mix, raises
TypeError.  On a CPU tensor it takes the plain version below (float64
too, for the exact reference runs).  Each counts its launches in
``.launches`` and by entry dtype in ``.launches_by_dtype`` (CPU calls do
not count); ``conv_stats.launches_by_shape`` counts them again by (N, H,
W, C, F, K, stride, padding, dtype), so a run can tell the TPU rows they
replace apart.  ``reset_launches()`` zeroes them.  A kernel reads
NHWC-contiguous activations: an input that is not (the fed image, a pool
output in NCHW memory) is copied once and counted in
``conv_bn_act.layout_copies`` — on either device, so a test can see that
the layout of a program stays copy-free.  The weight, a permuted view of
the [F, C, K, K] parameter, is made contiguous on every call: it is small.

``ConvBnAct`` (``conv_bn_act_trainable``) is the counterpart of
``make_conv_bn_act(bwd="analytic")``: the kernels forward, the closed-form
BN / ReLU gradient backward in fp32, with the conv output (already in
memory) as its residual, and dx / dw from ``aten.convolution_backward`` in
the activations' dtype — the JAX module takes them from ``jax.vjp`` of
XLA's conv, outside Pallas too.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["ConvBnAct", "bn_epilogue", "bn_epilogue_reference",
           "conv_bn_act", "conv_bn_act_reference", "conv_bn_act_trainable",
           "conv_stats", "conv_stats_reference", "reset_launches"]

_ACTS = ("relu", "", None)
# the partial-sum buffers' height is ceil(M / _TILE_M): _TILE_M must not
# exceed any conv_stats kernel's row tile (TILE_M = 128 in
# csrc/conv_epilogue.cu), or a kernel would write past the scratch
_TILE_M = 128
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_HALF = (torch.bfloat16, torch.float16)


def _check_act(act) -> None:
    if act not in _ACTS:
        raise ValueError(f"unsupported act {act!r} (relu or none)")


def _geometry(x_shape, w_shape, stride: int, padding: int):
    N, H, W, C = x_shape
    K, K2, C2, Fo = w_shape
    if K != K2 or C != C2:
        raise ValueError(f"weight shape {tuple(w_shape)} incompatible with x "
                         f"{tuple(x_shape)}")
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    if Ho < 1 or Wo < 1:
        raise ValueError(f"empty conv output for x {tuple(x_shape)}, K={K}, "
                         f"stride={stride}, padding={padding}")
    return N, H, W, C, Fo, K, Ho, Wo


# -- plain versions ----------------------------------------------------------

def _wide(dtype) -> torch.dtype:
    """The dtype the math runs in for activations of ``dtype``: fp32 for a
    half-width one, its own otherwise."""
    return torch.float32 if dtype in _HALF else dtype


def _conv_wide(x, w, stride, padding):
    """conv(x, w) NHWC in the wide dtype over the inputs' values (bf16
    widens exactly, so every product is exact and the sums are fp32)."""
    wd = _wide(x.dtype)
    return F.conv2d(x.permute(0, 3, 1, 2).to(wd), w.permute(3, 2, 0, 1).to(wd),
                    stride=stride, padding=padding).permute(0, 2, 3, 1)


def conv_stats_reference(x, w, stride: int = 1, padding: int = 0):
    """Plain version of ``conv_stats``: F.conv2d in fp32 (in float64 for
    float64 inputs) on permuted views, the per-channel sum and sum of
    squares over N, Ho, Wo of that unrounded result, and the conv output
    rounded to x's dtype."""
    out = _conv_wide(x, w, stride, padding).contiguous()
    return (out.to(x.dtype), out.sum(dim=(0, 1, 2)),
            (out * out).sum(dim=(0, 1, 2)))


def bn_epilogue_reference(out, mean, inv, gamma, beta, z=None, act="relu"):
    """Plain version of ``bn_epilogue``: the affine, residual and ReLU in
    fp32 over the widened ``out`` and z, y rounded to out's dtype."""
    _check_act(act)
    wd = _wide(out.dtype)
    y = (out.to(wd) - mean) * inv * gamma + beta
    if z is not None:
        y = y + z.to(wd)
    return (torch.relu(y) if act == "relu" else y).to(out.dtype)


def conv_bn_act_reference(x, w, gamma, beta, z=None, *, stride: int = 1,
                          padding: int = 0, eps: float = 1e-5, act="relu"):
    """Plain conv + batch-norm (batch statistics, two-pass variance) +
    residual + activation: the counterpart of the JAX module's
    ``conv_bn_act_reference``, which rounds the conv output to x's dtype
    and takes the statistics from the rounded values.  Returns (y, mean,
    var)."""
    _check_act(act)
    out = _conv_wide(x, w, stride, padding).to(x.dtype)
    var, mean = torch.var_mean(out.to(_wide(x.dtype)), dim=(0, 1, 2),
                               unbiased=False)
    y = bn_epilogue_reference(out, mean, torch.rsqrt(var + eps), gamma, beta,
                              z, act)
    return y, mean, var


# -- CUDA entries ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _entry(kernel: str, dtype: torch.dtype):
    """The C entry ``<kernel>_f32`` or ``<kernel>_bf16`` for ``dtype``."""
    fn = getattr(_build.library("conv_epilogue"), f"{kernel}_{DTYPES[dtype]}")
    if kernel == "conv_stats":
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
    else:  # bn_epilogue
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(t, kernel: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {t.device}")
    return True


def _dtype_of(kernel: str, on_cuda: bool, **named) -> torch.dtype:
    """The one element dtype of the activations ``named``: float32 or
    bfloat16 (on the CPU also float64, for the exact reference runs); any
    other dtype, or a mix, raises TypeError."""
    dtypes = {name: t.dtype for name, t in named.items()}
    first, dtype = next(iter(dtypes.items()))
    allowed = tuple(DTYPES) + (() if on_cuda else (torch.float64,))
    if dtype not in allowed:
        raise TypeError(f"{kernel} takes float32 or bfloat16, {first} is "
                        f"{dtype}")
    mixed = {n: d for n, d in dtypes.items() if d != dtype}
    if mixed:
        raise TypeError(f"{kernel} takes one dtype: {first} is {dtype}, "
                        + ", ".join(f"{n} is {d}" for n, d in mixed.items()))
    return dtype


def _check(kernel: str, ref, vectors=(), **named) -> None:
    """Device and contiguity of every tensor; the [F] ``vectors`` are
    float32 whatever the activations' dtype."""
    for name, t in named.items():
        if t.device != ref.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not "
                             f"{ref.device}")
        if name in vectors and t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes a float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _count(wrapper, dtype: torch.dtype) -> None:
    wrapper.launches += 1
    wrapper.launches_by_dtype[str(dtype).removeprefix("torch.")] += 1


def _nhwc(t):
    """t itself when NHWC-contiguous, else one counted copy."""
    if t.is_contiguous():
        return t
    conv_bn_act.layout_copies += 1
    return t.contiguous()


def conv_stats(x, w, stride: int = 1, padding: int = 0):
    """(out [N, Ho, Wo, F] in x's dtype, sum [F], sumsq [F] in fp32) of
    conv(x, w).  CUDA tensors launch ``conv_stats_f32`` or
    ``conv_stats_bf16``; CPU tensors take :func:`conv_stats_reference`."""
    N, H, W, C, Fo, K, Ho, Wo = _geometry(x.shape, w.shape, stride, padding)
    on_cuda = _on_cuda(x, "conv_stats")
    dtype = _dtype_of("conv_stats", on_cuda, x=x, w=w)
    x = _nhwc(x)
    if not on_cuda:
        return conv_stats_reference(x, w, stride, padding)
    w = w.contiguous()
    _check("conv_stats", x, x=x, w=w)
    tiles = -(-N * Ho * Wo // _TILE_M)
    out = torch.empty(N, Ho, Wo, Fo, dtype=dtype, device=x.device)
    part = torch.empty(2, tiles, Fo, dtype=torch.float32, device=x.device)
    sums = torch.empty(2, Fo, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry("conv_stats", dtype)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            N, H, W, C, Fo, K, int(stride), int(padding), Ho, Wo,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv_stats")
    _count(conv_stats, dtype)
    conv_stats.launches_by_shape[(N, H, W, C, Fo, K, int(stride),
                                  int(padding),
                                  str(dtype).removeprefix("torch."))] += 1
    return out, sums[0], sums[1]


def bn_epilogue(out, mean, inv, gamma, beta, z=None, act="relu"):
    """y = act((out - mean) * inv * gamma + beta [+ z]) over NHWC ``out``,
    in out's dtype.  CUDA tensors launch ``bn_epilogue_f32`` or
    ``bn_epilogue_bf16``; CPU tensors take :func:`bn_epilogue_reference`."""
    _check_act(act)
    on_cuda = _on_cuda(out, "bn_epilogue")
    acts = dict(out=out) if z is None else dict(out=out, z=z)
    _dtype_of("bn_epilogue", on_cuda, **acts)
    if z is not None:
        if z.shape != out.shape:
            raise ValueError(f"residual {tuple(z.shape)} is not the conv "
                             f"output's shape {tuple(out.shape)}")
        z = _nhwc(z)
    if not on_cuda:
        return bn_epilogue_reference(out, mean, inv, gamma, beta, z, act)
    Fo = out.shape[-1]
    vecs = dict(mean=mean, inv=inv, gamma=gamma, beta=beta)
    for name, v in vecs.items():
        if v.shape != (Fo,):
            raise ValueError(f"bn_epilogue: {name} must be [{Fo}], got "
                             f"{tuple(v.shape)}")
    named = dict(out=out, **vecs)
    if z is not None:
        named["z"] = z
    _check("bn_epilogue", out, vectors=tuple(vecs), **named)
    y = torch.empty_like(out)
    with torch.cuda.device(out.device):
        err = _entry("bn_epilogue", out.dtype)(
            out.data_ptr(), mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), None if z is None else z.data_ptr(),
            y.data_ptr(), out.numel() // Fo, Fo, int(act == "relu"),
            torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "bn_epilogue")
    _count(bn_epilogue, out.dtype)
    return y


def _batch_stats(out, ssum, ssq):
    """(mean, var) of the conv output from its channel sums: the TPU
    kernel's one-pass var = max(sumsq / count - mean^2, 0)."""
    count = out.shape[0] * out.shape[1] * out.shape[2]
    mean = ssum / count
    return mean, torch.clamp(ssq / count - mean * mean, min=0.0)


def conv_bn_act(x, w, gamma, beta, z=None, *, stride: int = 1,
                padding: int = 0, eps: float = 1e-5, act="relu"):
    """Fused conv2d + batch-norm (batch statistics) + residual +
    activation: x [N, H, W, C], w [K, K, C, F], gamma / beta [F], z
    optional [N, Ho, Wo, F].  Returns (y, mean, var)."""
    _check_act(act)
    out, ssum, ssq = conv_stats(x, w, stride, padding)
    mean, var = _batch_stats(out, ssum, ssq)
    y = bn_epilogue(out, mean, torch.rsqrt(var + eps), gamma, beta, z, act)
    return y, mean, var


class ConvBnAct(torch.autograd.Function):
    """The kernels forward; the analytic backward of the JAX module's
    ``make_conv_bn_act`` (conv_epilogue.py:477-508) in plain torch, dtype
    for dtype: the closed form in fp32 over the widened ``out``, dout
    rounded to out's dtype before the conv backward (so dx and dw come
    back in the activations' dtype), dgamma and dbeta in gamma's dtype,
    dz in y's."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, z, stride, padding, eps, act):
        ctx.set_materialize_grads(False)
        x = _nhwc(x)
        out, ssum, ssq = conv_stats(x, w, stride, padding)
        mean, var = _batch_stats(out, ssum, ssq)
        y = bn_epilogue(out, mean, torch.rsqrt(var + eps), gamma, beta, z,
                        act)
        # x as the kernel read it; w as given: a view of the [F, C, K, K]
        # parameter, which the backward permutes back
        ctx.save_for_backward(x, w, out, gamma, y, mean, var)
        ctx.cfg = (stride, padding, eps, act, z is not None)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, w, out, gamma, y, mean, var = ctx.saved_tensors
        stride, padding, eps, act, has_z = ctx.cfg
        wd = _wide(out.dtype)
        count = out.shape[0] * out.shape[1] * out.shape[2]
        inv = torch.rsqrt(var + eps)
        g = (torch.zeros(out.shape, dtype=wd, device=out.device)
             if dy is None else _nhwc(dy).to(wd))
        if act == "relu":
            # y > 0 <=> pre-activation > 0; relu'(0) = 0
            g = torch.where(y > 0, g, torch.zeros_like(g))
        of = out.to(wd)
        xhat = (of - mean) * inv
        dgamma = (g * xhat).sum(dim=(0, 1, 2))
        dbeta = g.sum(dim=(0, 1, 2))
        dxhat = g * gamma.to(wd)
        m1 = dxhat.mean(dim=(0, 1, 2))
        m2 = (dxhat * xhat).mean(dim=(0, 1, 2))
        dout = inv * (dxhat - m1 - xhat * m2)
        del dxhat, xhat
        # cotangents on the mean / var outputs (the parity tests drive
        # them; the moving-stat update takes no gradient in a program)
        if dmean is not None:
            dout = dout + dmean.to(wd) / count
        if dvar is not None:
            dout = dout + dvar.to(wd) * 2.0 * (of - mean) / count
        del of
        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dx = dw = None
        if need_dx or need_dw:
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dout.to(out.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
                w.permute(3, 2, 0, 1), None, [stride, stride],
                [padding, padding], [1, 1], False, [0, 0], 1,
                [need_dx, need_dw, False])
            dx = None if dx is None else dx.permute(0, 2, 3, 1)
            dw = None if dw is None else dw.permute(2, 3, 1, 0)
        dz = g.to(y.dtype) if has_z else None
        return (dx, dw, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), dz,
                None, None, None, None)


def conv_bn_act_trainable(x, w, gamma, beta, z=None, *, stride: int = 1,
                          padding: int = 0, eps: float = 1e-5, act="relu"):
    """Differentiable :func:`conv_bn_act` in x, w, gamma, beta and z:
    (y, mean, var)."""
    _check_act(act)
    return ConvBnAct.apply(x, w, gamma, beta, z, int(stride), int(padding),
                           float(eps), act or "")


def reset_launches() -> None:
    """Zero both wrappers' launch counts (total, by dtype and by shape)."""
    for wrapper in (conv_stats, bn_epilogue):
        wrapper.launches = 0
        wrapper.launches_by_dtype = {str(d).removeprefix("torch."): 0
                                     for d in DTYPES}
    conv_stats.launches_by_shape = collections.Counter()


reset_launches()
conv_bn_act.layout_copies = 0
