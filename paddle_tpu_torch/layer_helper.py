"""LayerHelper: shared plumbing for layer functions (counterpart of
paddle_tpu/layer_helper.py) — parameters in the startup and main programs,
temporary output vars, the activation tail."""

from __future__ import annotations

from typing import Any, Optional

from .core.framework import (Parameter, Variable, default_main_program,
                             default_startup_program, unique_name)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs: Any):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def append_op(self, *args, **kwargs):
        return self.block.append_op(*args, **kwargs)

    @property
    def param_attr(self) -> Optional[ParamAttr]:
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self) -> Optional[ParamAttr]:
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr: Optional[ParamAttr], shape, dtype,
                         is_bias: bool = False,
                         default_initializer=None) -> Optional[Parameter]:
        if attr is None or attr is False:
            return None
        if not isinstance(attr, ParamAttr):
            attr = ParamAttr._to_attr(attr)
        init = attr.initializer or default_initializer
        if init is None:
            init = ConstantInitializer(0.0) if is_bias else XavierInitializer()
        name = attr.name or unique_name(
            f"{self.name}.w" if not is_bias else f"{self.name}.b")

        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(name=name, shape=list(shape),
                                      dtype=dtype, persistable=True)
        init(sv, startup_block)

        kwargs = attr._to_kwargs()
        kwargs["name"] = name
        param = self.main_program.global_block().create_parameter(
            shape=list(shape), dtype=dtype, **kwargs)
        if attr.sharding is not None:
            param.sharding = attr.sharding
        return param

    def create_variable_for_type_inference(
            self, dtype, stop_gradient: bool = False) -> Variable:
        return self.block.create_var(name=unique_name(f"{self.name}.tmp"),
                                     dtype=dtype, shape=[],
                                     stop_gradient=stop_gradient)

    def set_variable_initializer(self, var: Variable, initializer) -> None:
        startup_block = self.startup_program.global_block()
        sv = startup_block.create_var(name=var.name, shape=list(var.shape),
                                      dtype=var.dtype, persistable=True)
        initializer(sv, startup_block)

    def append_bias_op(self, input_var: Variable, dim_start: int = 1,
                       dim_end=None) -> Variable:
        bias_attr = self.bias_attr
        if bias_attr is None:
            return input_var
        b = self.create_parameter(
            bias_attr, shape=list(input_var.shape)[dim_start:dim_end],
            dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var: Variable) -> Variable:
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out
