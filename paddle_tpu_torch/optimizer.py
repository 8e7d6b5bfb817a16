"""Optimizers (counterpart of paddle_tpu/optimizer.py): ``minimize``
appends the backward ops and one update op per parameter to the program.

Ported: the ``Optimizer`` base and ``MomentumOptimizer``.  Gradient clipping
and regularization are not ported, and asking for them raises.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

from .core.backward import append_backward
from .core.framework import (Parameter, Variable, default_main_program,
                             default_startup_program, program_guard,
                             unique_name)
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["Momentum", "MomentumOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        if regularization is not None:
            raise NotImplementedError("regularization is not ported")
        self._learning_rate = learning_rate
        self._name = name
        self._learning_rate_map: Dict[int, Variable] = {}
        # accumulators[acc_name][param_name] -> Variable
        self._accumulators: Dict[str, Dict[str, Variable]] = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None

    # -- learning rate -------------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if id(program) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(program)] = self._learning_rate
            return
        name = unique_name("learning_rate")
        lr_var = program.global_block().create_var(
            name=name, shape=[1], dtype="float32", persistable=True,
            stop_gradient=True)
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=name, shape=[1], dtype="float32",
                                persistable=True)
        ConstantInitializer(float(self._learning_rate))(sv, startup)
        self._learning_rate_map[id(program)] = lr_var

    def _create_param_lr(self, param_and_grad) -> Variable:
        param = param_and_grad[0]
        if getattr(param, "optimize_attr", {}).get("learning_rate", 1.0) != 1.0:
            raise NotImplementedError("per-parameter learning rates are "
                                      "not ported")
        return self._learning_rate_map[id(default_main_program())]

    # -- accumulators --------------------------------------------------------
    def _add_accumulator(self, name: str, param: Parameter,
                         fill_value: float = 0.0) -> Variable:
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var_name = unique_name(f"{param.name}_{name}")
        shape = list(param.shape)
        var = default_main_program().global_block().create_var(
            name=var_name, shape=shape, dtype=param.dtype, persistable=True,
            stop_gradient=True)
        startup = default_startup_program().global_block()
        sv = startup.create_var(name=var_name, shape=shape, dtype=param.dtype,
                                persistable=True)
        ConstantInitializer(fill_value)(sv, startup)
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name: str, param: Parameter) -> Variable:
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- the optimization pass -----------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads, loss):
        block = loss.block.program.current_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads if pg[1] is not None]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Backward + optimizer ops; returns (optimize_ops, params_grads)."""
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = append_backward(loss, parameter_list, no_grad_set)
            for p, _ in params_grads:
                if (getattr(p, "gradient_clip_attr", None) is not None
                        or getattr(p, "regularizer", None) is not None):
                    raise NotImplementedError(
                        f"{p.name}: gradient clipping and regularization "
                        "are not ported")
            optimize_ops = self._create_optimization_pass(params_grads, loss)
        return optimize_ops, params_grads


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, regularization=None,
                 name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": False})


Momentum = MomentumOptimizer
