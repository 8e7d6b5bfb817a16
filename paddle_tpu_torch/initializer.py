"""Initializers — append init ops to the startup program (counterpart of
paddle_tpu/initializer.py: Constant, Uniform, Normal, Xavier,
NumpyArray)."""

from __future__ import annotations

import math

import numpy as np

from .core.proto import DataType

__all__ = ["Constant", "ConstantInitializer", "Initializer", "Normal",
           "NormalInitializer", "NumpyArrayInitializer", "Uniform",
           "UniformInitializer", "Xavier", "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = list(var.shape)
        if len(shape) < 2:
            return (shape[0] if shape else 1, shape[0] if shape else 1)
        receptive = 1
        for d in shape[2:]:
            receptive *= d
        return shape[1] * receptive, shape[0] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": int(var.dtype),
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": int(var.dtype),
                   "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": int(var.dtype),
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class XavierInitializer(Initializer):
    """Glorot init, the uniform form (the normal one needs gaussian_random,
    not ported)."""

    def __init__(self, fan_in=None, fan_out=None, seed: int = 0):
        self.fan_in, self.fan_out, self.seed = fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return UniformInitializer(-limit, limit, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        attrs = {"shape": list(self.value.shape), "dtype": int(var.dtype)}
        if var.dtype in (DataType.INT32, DataType.INT64):
            attrs["int32_values"] = (
                self.value.astype(np.int64).reshape(-1).tolist())
        else:
            attrs["fp32_values"] = (
                self.value.astype(np.float64).reshape(-1).tolist())
        return block.append_op(type="assign_value",
                               outputs={"Out": [var.name]}, attrs=attrs)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
