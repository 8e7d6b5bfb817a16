"""Op rules of the port (counterparts of paddle_tpu/ops/*.py): each is a
compile-time ``infer_shape`` plus a torch lowering.  Importing this
package registers them; ``paddle_tpu_torch/__init__.py`` does so.

The files mirror the JAX package's and hold only the rules the ported
models need: the Transformer and ResNet (conv tier) training programs.
"""

from . import (  # noqa: F401
    activation_ops,
    attention_ops,
    compare_ops,
    elementwise_ops,
    loss_ops,
    math_ops,
    metric_ops,
    nn_ops,
    optimizer_ops,
    reduce_ops,
    tensor_ops,
)
