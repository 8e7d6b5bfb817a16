"""fluid.layers for the port: the layer functions the ported models call
(counterparts in the mirrored files of paddle_tpu/layers)."""

from . import control_flow, io, nn, tensor  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
