"""Neural-network layers (counterpart of paddle_tpu/layers/nn.py): the
functions the Transformer and ResNet models call."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.framework import unique_name
from ..core.proto import DataType
from ..initializer import (ConstantInitializer, NormalInitializer,
                           XavierInitializer)
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["accuracy", "batch_norm", "conv2d", "conv_bn_add_act",
           "cross_entropy", "dropout", "elementwise_add", "elementwise_div",
           "elementwise_mul", "embedding", "fc", "fused_attention",
           "fused_bn_add_act", "layer_norm", "matmul", "pool2d", "relu",
           "softmax", "softmax_with_cross_entropy", "topk"]


def _pair(x, n=2):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x] * n


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, name: Optional[str] = None):
    """Fully-connected layer on one input: ``mul``, the bias add and the
    activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    fan_in = int(np.prod([abs(d)
                          for d in list(input.shape)[num_flatten_dims:]]))
    w = helper.create_parameter(helper.param_attr, shape=[fan_in, size],
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="mul", inputs={"X": [input], "Y": [w]}, outputs={"Out": [out]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(out, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
           use_cudnn: bool = True, act: Optional[str] = None,
           name: Optional[str] = None):
    """2-D convolution, NCHW: the ``conv2d`` op with an N(0, 2 / fan_in)
    filter [num_filters, C / groups, kh, kw], then the bias (unless
    ``bias_attr=False``) as ``elementwise_add`` on axis 1, then ``act``.
    ``use_cudnn`` is accepted and ignored, as in the JAX package."""
    helper = LayerHelper("conv2d", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    fsize = _pair(filter_size)
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    w = helper.create_parameter(
        helper.param_attr,
        shape=[num_filters, num_channels // groups] + fsize, dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups})
    pre_act = out
    if helper.bias_attr is not None:
        b = helper.create_parameter(helper.bias_attr, shape=[num_filters],
                                    dtype=dtype, is_bias=True)
        pre_act = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [pre_act]}, attrs={"axis": 1})
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None):
    helper = LayerHelper("pool2d", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def _bn_state(helper, c, dtype, param_attr, bias_attr, moving_mean_name,
              moving_variance_name):
    """Batch-norm parameters and state: scale (1), bias (0), the moving
    mean (0) and variance (1) as persistable vars with startup
    initializers, the saved statistics and the output var."""
    scale = helper.create_parameter(
        param_attr or ParamAttr(), shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr or ParamAttr(), shape=[c],
                                   dtype=dtype, is_bias=True)
    block = helper.main_program.global_block()
    mean = block.create_var(
        name=moving_mean_name or unique_name(f"{helper.name}.mean"),
        shape=[c], dtype=dtype, persistable=True, stop_gradient=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = block.create_var(
        name=moving_variance_name or unique_name(f"{helper.name}.var"),
        shape=[c], dtype=dtype, persistable=True, stop_gradient=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    return scale, bias, mean, variance, saved_mean, saved_var, out


def _bn_build(helper, input, data_layout, moving_mean_name,
              moving_variance_name):
    """The state and slots batch_norm and fused_bn_add_act share: (inputs,
    outputs, out var)."""
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale, bias, mean, variance, saved_mean, saved_var, out = _bn_state(
        helper, c, input.dtype, helper.param_attr, helper.bias_attr,
        moving_mean_name, moving_variance_name)
    inputs = {"X": [input], "Scale": [scale], "Bias": [bias],
              "Mean": [mean], "Variance": [variance]}
    outputs = {"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
               "SavedMean": [saved_mean], "SavedVariance": [saved_var]}
    return inputs, outputs, out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Batch normalization; the moving mean and variance are persistable
    state vars the op updates in the program."""
    helper = LayerHelper("batch_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs, outputs, out = _bn_build(helper, input, data_layout,
                                     moving_mean_name, moving_variance_name)
    helper.append_op(
        type="batch_norm", inputs=inputs, outputs=outputs,
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def fused_bn_add_act(x, y=None, act="relu", is_test=False, momentum=0.9,
                     epsilon=1e-5, param_attr=None, bias_attr=None,
                     data_layout="NCHW", name=None, moving_mean_name=None,
                     moving_variance_name=None, use_global_stats=False):
    """batch_norm(x) [+ y] -> act as one op, tagged ``@recompute@``: its
    backward keeps nothing op-internal (ops/nn_ops.py
    ``fused_bn_add_act``)."""
    helper = LayerHelper("fused_bn_add_act", input=x, param_attr=param_attr,
                         bias_attr=bias_attr, act=None, name=name)
    inputs, outputs, out = _bn_build(helper, x, data_layout,
                                     moving_mean_name, moving_variance_name)
    if y is not None:
        inputs["Z"] = [y]
    helper.append_op(
        type="fused_bn_add_act", inputs=inputs, outputs=outputs,
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats, "act": act,
               "@recompute@": True})
    return out


def conv_bn_add_act(input, num_filters, filter_size, residual=None,
                    stride=1, padding=0, groups=1, act="relu",
                    is_test=False, momentum=0.9, epsilon=1e-5,
                    param_attr=None, bn_param_attr=None, bn_bias_attr=None,
                    moving_mean_name=None, moving_variance_name=None,
                    name=None):
    """conv2d (no bias) + batch_norm + residual + activation as one op
    (ops/nn_ops.py ``conv_bn_add_act``).  NCHW contract, square filter,
    stride and padding; the filter is N(0, 2 / fan_in)."""
    helper = LayerHelper("conv_bn_add_act", input=input,
                         param_attr=param_attr, act=None, name=name)
    dtype = input.dtype
    num_channels = input.shape[1]
    fsize = _pair(filter_size)
    if fsize[0] != fsize[1]:
        raise ValueError("conv_bn_add_act needs a square filter")
    if _pair(stride)[0] != _pair(stride)[1] or \
            _pair(padding)[0] != _pair(padding)[1]:
        raise NotImplementedError(
            "conv_bn_add_act needs square stride/padding "
            f"(got stride={stride}, padding={padding})")
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    w = helper.create_parameter(
        helper.param_attr, shape=[num_filters, num_channels // groups] + fsize,
        dtype=dtype,
        default_initializer=NormalInitializer(0.0, (2.0 / fan_in) ** 0.5))
    scale, bias, mean, variance, saved_mean, saved_var, out = _bn_state(
        helper, num_filters, dtype, bn_param_attr, bn_bias_attr,
        moving_mean_name, moving_variance_name)
    inputs = {"X": [input], "Filter": [w], "Scale": [scale], "Bias": [bias],
              "Mean": [mean], "Variance": [variance]}
    if residual is not None:
        inputs["Z"] = [residual]
    helper.append_op(
        type="conv_bn_add_act", inputs=inputs,
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "groups": groups, "momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "act": act})
    return out


def softmax(input, use_cudnn=True, name=None, axis=-1):
    helper = LayerHelper("softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy", inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", input=input, name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference(DataType.INT64,
                                                        stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """Classification accuracy: top_k, then the accuracy op."""
    helper = LayerHelper("accuracy", input=input)
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(DataType.FP32,
                                                        stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        DataType.INT32, stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        DataType.INT32, stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    return acc_out


def embedding(input, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False,
              padding_idx: Optional[int] = None, param_attr=None,
              dtype="float32", name: Optional[str] = None):
    """Embedding lookup (lookup_table); the padding_idx row reads as zeros
    and takes no gradient.  Dense gradients only (is_sparse=False)."""
    if is_sparse:
        raise NotImplementedError("sparse (SelectedRows) embedding "
                                  "gradients are not ported")
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype,
                                default_initializer=XavierInitializer())
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod([abs(d)
                               for d in input.shape[begin_norm_axis:]]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, shape=norm_shape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(DataType.UINT8,
                                                     stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               smooth_eps=0.0):
    """smooth_eps folds uniform label smoothing over hard labels into the
    op: loss = (1-eps) * CE(label) + eps * mean_V(-log p)."""
    if smooth_eps and soft_label:
        raise ValueError("smooth_eps folds smoothing over HARD labels; "
                         "pre-smoothed soft labels must not smooth twice")
    helper = LayerHelper("softmax_with_cross_entropy", input=logits)
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "smooth_eps": float(smooth_eps)})
    if return_softmax:
        return loss, softmax_out
    return loss


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": float(alpha)})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def fused_attention(q, k, v, causal=False, scale=None, k_lengths=None,
                    name=None):
    """Flash attention in one op: q/k/v [B, H, S, D], optional [B] valid
    key counts instead of an additive bias (kernels/flash_attention.py)."""
    helper = LayerHelper("fused_attention", input=q, name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if k_lengths is not None:
        inputs["KLengths"] = [k_lengths]
    helper.append_op(
        type="fused_attention", inputs=inputs, outputs={"Out": [out]},
        attrs={"causal": causal, "scale": float(scale) if scale else 0.0})
    return out
