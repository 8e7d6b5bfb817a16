"""Neural-network layers (counterpart of paddle_tpu/layers/nn.py): the
functions the Transformer model calls."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_div", "elementwise_mul",
           "embedding", "fused_attention", "layer_norm", "matmul", "relu",
           "softmax_with_cross_entropy"]


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
