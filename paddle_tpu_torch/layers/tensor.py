"""Tensor creation/manipulation layers (counterpart of
paddle_tpu/layers/tensor.py)."""

from __future__ import annotations

from ..core.proto import convert_dtype
from ..layer_helper import LayerHelper

__all__ = ["cast", "create_parameter", "fill_constant_batch_size_like",
           "reduce_sum", "reshape", "scale", "split", "squeeze",
           "transpose"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def cast(x, dtype):
    helper = LayerHelper("cast", input=x)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": int(x.dtype),
                            "out_dtype": int(dtype)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="fill_constant_batch_size_like", inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": int(dtype),
               "value": float(value), "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def reshape(x, shape, act=None, name=None):
    helper = LayerHelper("reshape2", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": list(axes)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections``: an int (that many equal parts) or a list of
    part sizes along ``dim``; returns the list of parts."""
    helper = LayerHelper("split", input=input, name=name)
    if isinstance(num_or_sections, int):
        num, sections = num_or_sections, []
    else:
        num, sections = 0, list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(num or len(sections))]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"num": num, "sections": sections, "axis": dim})
    return outs


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", input=x, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dims), "keep_dim": keep_dim,
                 "reduce_all": False}
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
