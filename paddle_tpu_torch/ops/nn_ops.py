"""Neural-network ops (counterpart of paddle_tpu/ops/nn_ops.py): conv2d,
layer_norm, batch_norm, fused_bn_add_act, pool2d, softmax, dropout and
conv_bn_add_act (train mode, on the conv-epilogue kernels)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import amp
from ..core.proto import DataType
from ..core.registry import register_op
from ..kernels.conv_epilogue import conv_bn_act_trainable
from .common import in_desc, same_shape, set_output


# -- conv --------------------------------------------------------------------
def _conv_out_dim(size, k, pad, stride, dilation=1):
    if size < 0:
        return -1
    return (size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def _conv2d_infer(op, block):
    x = in_desc(op, block, "Input")
    f = in_desc(op, block, "Filter")
    if x is None or f is None:
        return
    strides = op.attr("strides", [1, 1])
    paddings = op.attr("paddings", [0, 0])
    dilations = op.attr("dilations", [1, 1])
    n, _, h, w = x.shape
    oc, _, kh, kw = f.shape
    set_output(block, op, "Output",
               [n, oc, _conv_out_dim(h, kh, paddings[0], strides[0],
                                     dilations[0]),
                _conv_out_dim(w, kw, paddings[1], strides[1], dilations[1])],
               x.dtype)


@register_op("conv2d", infer_shape=_conv2d_infer,
             diff_inputs=["Input", "Filter"])
def _conv2d(ctx, ins, attrs):
    """NCHW conv (cuDNN on the card): the JAX rule's XLA conv, which no
    Pallas kernel replaces.  Operands through ``amp.mxu_operands``, the
    output through ``amp.mxu_output``.  The input is taken in channels-last
    memory (one copy for the fed image, none after: the conv, the
    elementwise rules and pooling keep the format), the layout cuDNN's
    fastest kernels read; the JAX rule's NHWC branch of FLAGS_conv_layout
    only reorders XLA's computation and has no counterpart."""
    x, f = ins["Input"][0], ins["Filter"][0]
    xc, fc = amp.mxu_operands(x, f)
    out = F.conv2d(xc.contiguous(memory_format=torch.channels_last), fc,
                   stride=list(attrs.get("strides", [1, 1])),
                   padding=list(attrs.get("paddings", [0, 0])),
                   dilation=list(attrs.get("dilations", [1, 1])),
                   groups=int(attrs.get("groups", 1) or 1))
    return {"Output": [amp.mxu_output(out, x, f)]}


def _layer_norm_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Y", x.shape, x.dtype)
    begin = op.attr("begin_norm_axis", 1)
    lead = 1
    ok = all(d >= 0 for d in x.shape[:begin])
    for d in x.shape[:begin]:
        lead *= d
    set_output(block, op, "Mean", [lead if ok else -1], x.dtype)
    set_output(block, op, "Variance", [lead if ok else -1], x.dtype)


@register_op("layer_norm", infer_shape=_layer_norm_infer,
             diff_inputs=["X", "Scale", "Bias"])
def _layer_norm(ctx, ins, attrs):
    """Normalize over the dims from begin_norm_axis on (population
    variance), then scale and shift.  The statistics and the affine are
    fp32 for a half-width x (amp keep_output); Y, Mean and Variance keep
    x's dtype."""
    x = ins["X"][0]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    xs = x.to(amp.stats_dtype(x))
    mean = xs.mean(dim=axes, keepdim=True)
    var = xs.var(dim=axes, keepdim=True, unbiased=False)
    y = (xs - mean) * torch.rsqrt(var + eps)
    tail_shape = (1,) * begin + tuple(x.shape[begin:])
    scale = ins.get("Scale", [None])[0]
    bias = ins.get("Bias", [None])[0]
    if scale is not None:
        y = y * scale.reshape(tail_shape)
    if bias is not None:
        y = y + bias.reshape(tail_shape)
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(-1).to(x.dtype)],
            "Variance": [var.reshape(-1).to(x.dtype)]}


# -- batch norm --------------------------------------------------------------
def _batch_norm_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Y", x.shape, x.dtype)
    c = x.shape[1] if op.attr("data_layout", "NCHW") == "NCHW" else x.shape[-1]
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_output(block, op, slot, [c], x.dtype)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm [+ residual] [+ ReLU] as one function with the
    closed-form backward.  Forward: the statistics over every axis but
    ``caxis`` in ``amp.stats_dtype(x)`` (two-pass variance, as jnp.var),
    the normalize + affine in that dtype, Y rounded to x's dtype, then
    ``+ z`` in Y's dtype and the ReLU.  It saves x in its own dtype, the
    mean and inv, and (with the ReLU) its own output for the mask — no
    activation-sized intermediate lives between forward and backward; the
    backward recomputes xhat from x.  This is the storage JAX's
    ``@recompute@`` tag asks for, and what keeps 53 batch norms at batch
    256 inside the card's memory."""

    @staticmethod
    def forward(ctx, x, scale, bias, z, eps, caxis, relu):
        ctx.set_materialize_grads(False)
        axes = tuple(i for i in range(x.dim()) if i != caxis)
        bshape = [1] * x.dim()
        bshape[caxis] = -1
        xs = x.to(amp.stats_dtype(x))
        var, mean = torch.var_mean(xs, dim=axes, unbiased=False)
        inv = torch.rsqrt(var + eps)
        # (xs - mean) * inv * scale + bias, in place on one new tensor
        # (autograd does not record inside forward); xs is left alone
        y = (xs - mean.reshape(bshape)).mul_(inv.reshape(bshape)).mul_(
            scale.reshape(bshape)).add_(bias.reshape(bshape)).to(x.dtype)
        del xs
        if z is not None:
            y = y.add_(z.to(y.dtype))
        if relu:
            y = y.relu_()
        ctx.save_for_backward(x, scale, mean, inv, y if relu else None)
        ctx.cfg = (axes, bshape, None if z is None else z.dtype)
        ctx.mark_non_differentiable(mean, var, inv)
        return y, mean, var, inv

    @staticmethod
    def backward(ctx, dy, dmean, dvar, dinv):
        x, scale, mean, inv, y = ctx.saved_tensors
        axes, bshape, z_dtype = ctx.cfg
        if dy is None:
            return None, None, None, None, None, None, None
        if y is not None:  # relu'(pre) = [y > 0]
            dy = torch.where(y > 0, dy, torch.zeros_like(dy))
        dz = None if z_dtype is None else dy.to(z_dtype)
        sd = mean.dtype
        g = dy.to(sd)  # may be dy itself, which other grad ops read
        xhat = (x.to(sd) - mean.reshape(bshape)).mul_(inv.reshape(bshape))
        dscale = (g * xhat).sum(dim=axes)
        dbias = g.sum(dim=axes)
        dxhat = g * scale.reshape(bshape).to(sd)
        del g
        m1 = dxhat.mean(dim=axes).reshape(bshape)
        m2 = (dxhat * xhat).mean(dim=axes).reshape(bshape)
        dx = dxhat.sub_(m1).sub_(xhat.mul_(m2)).mul_(inv.reshape(bshape))
        return (dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype),
                dz, None, None, None)


def _bn_core(ins, attrs, z=None, relu=False):
    """The batch-norm math shared by batch_norm and fused_bn_add_act (the
    JAX package's ``_bn_core``), with fused_bn_add_act's residual and
    ReLU.  Train mode: batch statistics in ``amp.stats_dtype(x)`` through
    :class:`_BatchNormTrain`, MeanOut / VarianceOut the momentum updates
    of the moving statistics.  ``is_test`` / ``use_global_stats``: the
    moving statistics normalize, in plain differentiable torch, and pass
    through.  Y in x's dtype (then + z and the ReLU), SavedMean the mean
    and SavedVariance rsqrt(var + eps), both in x's dtype."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        bshape = [1] * x.dim()
        bshape[caxis] = -1
        inv = torch.rsqrt(var + eps)
        y = ((x.to(inv.dtype) - mean.reshape(bshape)) * inv.reshape(bshape)
             * scale.reshape(bshape) + bias.reshape(bshape)).to(x.dtype)
        if z is not None:
            y = y + z.to(y.dtype)
        if relu:
            y = torch.relu(y)
        new_mean, new_var, saved_mean = mean, var, mean
    else:
        y, saved_mean, bvar, inv = _BatchNormTrain.apply(
            x, scale, bias, z, float(eps), caxis, relu)
        new_mean = momentum * mean + (1.0 - momentum) * saved_mean
        new_var = momentum * var + (1.0 - momentum) * bvar
    return {"Y": [y], "MeanOut": [new_mean], "VarianceOut": [new_var],
            "SavedMean": [saved_mean.to(x.dtype)],
            "SavedVariance": [inv.to(x.dtype)]}


@register_op("batch_norm", infer_shape=_batch_norm_infer,
             diff_inputs=["X", "Scale", "Bias"])
def _batch_norm(ctx, ins, attrs):
    """Train mode normalizes with the batch statistics and emits the
    updated moving statistics (MeanOut / VarianceOut alias the Mean /
    Variance state vars); test mode uses the moving statistics."""
    return _bn_core(ins, attrs)


def _fused_bn_add_act_infer(op, block):
    x, z = in_desc(op, block, "X"), in_desc(op, block, "Z")
    if x is not None and z is not None and list(z.shape) != list(x.shape):
        raise ValueError(
            f"fused_bn_add_act: residual Z shape {list(z.shape)} must equal "
            f"X shape {list(x.shape)} (op {op.type})")
    _batch_norm_infer(op, block)


@register_op("fused_bn_add_act", infer_shape=_fused_bn_add_act_infer,
             diff_inputs=["X", "Z", "Scale", "Bias"])
def _fused_bn_add_act(ctx, ins, attrs):
    """batch_norm + residual add (Z cast to Y's dtype) + activation (relu
    or none) as one op.  The layer tags it ``@recompute@``; the eager block
    runner has no recompute pass, and :class:`_BatchNormTrain` gives train
    mode the same storage: nothing op-internal is kept for the backward."""
    act = attrs.get("act") or None
    if act not in (None, "relu"):
        raise ValueError(f"fused_bn_add_act: unsupported act {act!r}")
    return _bn_core(ins, attrs, z=ins.get("Z", [None])[0],
                    relu=act == "relu")


# -- pooling -----------------------------------------------------------------
def _pool_out_dim(size, k, pad, stride, ceil_mode):
    if size < 0:
        return -1
    num = size + 2 * pad - k
    if ceil_mode:
        return -(-num // stride) + 1
    return num // stride + 1


def _pool2d_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    n, c, h, w = x.shape
    if op.attr("global_pooling", False):
        set_output(block, op, "Out", [n, c, 1, 1], x.dtype)
        return
    k = op.attr("ksize", [1, 1])
    s = op.attr("strides", [1, 1])
    p = op.attr("paddings", [0, 0])
    cm = op.attr("ceil_mode", False)
    set_output(block, op, "Out",
               [n, c, _pool_out_dim(h, k[0], p[0], s[0], cm),
                _pool_out_dim(w, k[1], p[1], s[1], cm)], x.dtype)


@register_op("pool2d", infer_shape=_pool2d_infer)
def _pool2d(ctx, ins, attrs):
    """NCHW max / avg pooling.  As the JAX rule's reduce_window: a max
    window pads with -inf, ceil_mode adds stride-1 more padding on the
    high side, and an exclusive avg divides by the window's in-image
    count.  torch's pooling keeps a channels-last input channels-last, so
    the conv ops around it stay copy-free."""
    if attrs.get("adaptive", False):
        raise NotImplementedError("adaptive pool2d is not ported")
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    if ptype not in ("max", "avg"):
        raise ValueError(f"pool2d: unsupported pooling_type {ptype!r}")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return {"Out": [x.amax(dim=(2, 3), keepdim=True)]}
        return {"Out": [x.mean(dim=(2, 3), keepdim=True)]}
    k = list(attrs.get("ksize", [1, 1]))
    s = list(attrs.get("strides", [1, 1]))
    p = list(attrs.get("paddings", [0, 0]))
    exclusive = attrs.get("exclusive", True)
    if attrs.get("ceil_mode", False) or any(2 * pp > kk
                                            for pp, kk in zip(p, k)):
        # explicit (low, high) padding, then an unpadded window
        pad = (p[1], p[1] + (s[1] - 1 if attrs.get("ceil_mode") else 0),
               p[0], p[0] + (s[0] - 1 if attrs.get("ceil_mode") else 0))
        if ptype == "max":
            return {"Out": [F.max_pool2d(F.pad(x, pad, value=float("-inf")),
                                         k, s)]}
        summed = F.avg_pool2d(F.pad(x, pad), k, s, divisor_override=1)
        if not exclusive:
            return {"Out": [summed / (k[0] * k[1])]}
        ones = F.pad(torch.ones_like(x[:1, :1]), pad)
        return {"Out": [summed / F.avg_pool2d(ones, k, s,
                                              divisor_override=1)
                        .clamp(min=1.0)]}
    if ptype == "max":
        return {"Out": [F.max_pool2d(x, k, s, p)]}
    return {"Out": [F.avg_pool2d(x, k, s, p,
                                 count_include_pad=not exclusive)]}


# -- softmax -----------------------------------------------------------------
@register_op("softmax", infer_shape=same_shape())
def _softmax(ctx, ins, attrs):
    # half-width logits exponentiate in fp32; Out keeps their dtype
    x = ins["X"][0]
    return {"Out": [torch.softmax(x.to(amp.stats_dtype(x)),
                                  dim=attrs.get("axis", -1)).to(x.dtype)]}


def _dropout_infer(op, block):
    x = in_desc(op, block, "X")
    if x is None:
        return
    set_output(block, op, "Out", x.shape, x.dtype, lod_level=x.lod_level)
    set_output(block, op, "Mask", x.shape, DataType.UINT8)


@register_op("dropout", infer_shape=_dropout_infer, diff_inputs=["X"])
def _dropout(ctx, ins, attrs):
    """Two implementations: downgrade_in_infer (the default; train keeps
    the kept values as they are, infer multiplies by 1 - p) and
    upscale_in_train (train scales the kept values by 1 / (1 - p), infer
    is the identity).  Out keeps X's dtype; Mask is uint8.  The keep mask
    is one uniform draw per element from the program's torch.Generator,
    on the executor's device, kept where u < 1 - p: one draw per op per
    step, as the JAX rule takes one key per op per step (the two streams
    differ)."""
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    # a scale rounds to x's dtype first, as JAX's weak-typed scalars do
    if attrs.get("is_test", False):
        out = (x if impl == "upscale_in_train"
               else x * torch.tensor(1.0 - p, dtype=x.dtype))
        return {"Out": [out], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    keep = torch.rand(x.shape, generator=ctx.generator,
                      device=ctx.device) < 1.0 - p
    if impl == "upscale_in_train":
        out = torch.where(keep, x / torch.tensor(max(1.0 - p, 1e-8),
                                                 dtype=x.dtype), 0.0)
    else:
        out = torch.where(keep, x, 0.0)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


# -- conv + batch_norm + residual + activation -------------------------------
def _conv_bn_add_act_infer(op, block):
    x = in_desc(op, block, "X")
    f = in_desc(op, block, "Filter")
    if x is None or f is None:
        return
    strides = op.attr("strides", [1, 1])
    paddings = op.attr("paddings", [0, 0])
    n, _, h, w = x.shape
    oc = f.shape[0]
    ho = _conv_out_dim(h, f.shape[2], paddings[0], strides[0])
    wo = _conv_out_dim(w, f.shape[3], paddings[1], strides[1])
    z = in_desc(op, block, "Z")
    if z is not None and list(z.shape) != [n, oc, ho, wo]:
        raise ValueError(
            f"conv_bn_add_act: residual Z shape {list(z.shape)} must equal "
            f"the conv output shape {[n, oc, ho, wo]}")
    set_output(block, op, "Y", [n, oc, ho, wo], x.dtype)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_output(block, op, slot, [oc], x.dtype)


@register_op("conv_bn_add_act", infer_shape=_conv_bn_add_act_infer,
             diff_inputs=["X", "Filter", "Scale", "Bias", "Z"])
def _conv_bn_add_act(ctx, ins, attrs):
    """conv2d + batch_norm (batch statistics) + residual + activation as
    one op, train mode: the conv_stats and bn_epilogue kernels forward
    (their plain versions on the CPU), the analytic backward.

    The JAX rule's AMP sites (nn_ops.py:566-631): X and Filter through
    ``amp.mxu_operands`` (so under either tier the kernels take bf16), Z
    rounded to that dtype, Y through ``amp.mxu_output``, the batch
    statistics in ``amp.stats_dtype(x)`` for the moving-statistic
    updates, SavedMean and SavedVariance in x's dtype.

    NCHW program contract, NHWC kernels, and no copies between them: the
    rule permutes X and Z to NHWC views, the kernel writes Y NHWC, and the
    rule returns Y permuted back — an NCHW-shaped tensor in channels-last
    memory, so the next op's permute is contiguous again.  Only an input
    in NCHW memory (the fed image) is copied, once, by the wrapper.  The
    moving statistics update in torch: momentum * old + (1 - momentum) *
    batch; SavedMean is the batch mean, SavedVariance rsqrt(var + eps)."""
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        raise NotImplementedError(
            "conv_bn_add_act in test mode (moving statistics) is not ported")
    groups = int(attrs.get("groups", 1) or 1)
    if groups != 1:
        raise NotImplementedError(
            f"conv_bn_add_act with groups={groups} is not ported")
    strides = attrs.get("strides", [1, 1])
    paddings = attrs.get("paddings", [0, 0])
    if strides[0] != strides[1] or paddings[0] != paddings[1]:
        raise NotImplementedError(
            "conv_bn_add_act needs square stride/padding "
            f"(got strides={strides}, paddings={paddings})")
    act = attrs.get("act") or ""
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    x, f, z = ins["X"][0], ins["Filter"][0], ins.get("Z", [None])[0]
    xc, fc = amp.mxu_operands(x, f)
    y, bmean, bvar = conv_bn_act_trainable(
        xc.permute(0, 2, 3, 1), fc.permute(2, 3, 1, 0),
        ins["Scale"][0], ins["Bias"][0],
        None if z is None else z.to(xc.dtype).permute(0, 2, 3, 1),
        stride=int(strides[0]), padding=int(paddings[0]), eps=eps, act=act)
    sd = amp.stats_dtype(x)
    bmean, bvar = bmean.to(sd), bvar.to(sd)
    return {
        "Y": [amp.mxu_output(y.permute(0, 3, 1, 2), x, f)],
        "MeanOut": [momentum * ins["Mean"][0] + (1.0 - momentum) * bmean],
        "VarianceOut": [momentum * ins["Variance"][0]
                        + (1.0 - momentum) * bvar],
        "SavedMean": [bmean.to(x.dtype)],
        "SavedVariance": [torch.rsqrt(bvar + eps).to(x.dtype)],
    }
