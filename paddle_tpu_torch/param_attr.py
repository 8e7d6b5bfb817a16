"""Parameter attributes (counterpart of paddle_tpu/param_attr.py).

``sharding`` (a per-dim list of mesh-axis names or None) is carried into
the parameter's desc, as the JAX package does; the port's single-card
executor does not act on it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None,
                 do_model_average: bool = False,
                 sharding: Optional[Sequence[Any]] = None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.sharding = list(sharding) if sharding is not None else None

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """None/True -> default, False -> no parameter, str -> named,
        ParamAttr as is, anything else is taken as an initializer."""
        if arg is None or arg is True:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        return ParamAttr(initializer=arg)

    def _to_kwargs(self):
        return {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
