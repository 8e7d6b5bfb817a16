"""fluid.layers for the port: the layer functions the ported models call
(counterparts in the mirrored files of paddle_tpu/layers)."""

from ..layer_helper import LayerHelper
from . import control_flow, io, nn, ops, tensor  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403


def mean(x, name=None):
    """Mean over all elements -> [1]."""
    helper = LayerHelper("mean", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out
