"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for one NVIDIA Hopper card, built slice by slice.  Module
names mirror the JAX package (``core/framework.py``,
``kernels/flash_attention.py``, ``serving/kvcache.py``, ...) so each
file's counterpart is easy to find.

It is used as fluid is::

    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ...  # fluid.layers.*
        fluid.optimizer.MomentumOptimizer(1e-4, 0.9).minimize(loss)
    exe = fluid.Executor()          # the card; CPUPlace() for the host
    exe.run(startup)
    exe.run(main, feed=..., fetch_list=[loss])

``fluid.enable_amp("bfloat16")`` computes the matmuls in bf16 and casts
their outputs back to fp32; ``enable_amp("bfloat16", keep_output=True)``
keeps them bf16 (``core/amp.py``).  With no call the port is fp32.

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Every
Pallas kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``kernels/csrc``), compiled by ``nvcc`` at first use
(``kernels/_build.py``).  Entry points run on the card; a caller asks for
the CPU explicitly (``CPUPlace()``, ``device="cpu"``), where each kernel
wrapper takes its plain PyTorch version.
"""

from . import layers, ops, optimizer  # noqa: F401  (ops registers the rules)
from .core.amp import disable_amp, enable_amp
from .core.executor import Executor
from .core.framework import (Program, default_main_program,
                             default_startup_program, program_guard)
from .core.place import CPUPlace, CUDAPlace
from .core.scope import Scope, global_scope
from .device import resolve_device
from .param_attr import ParamAttr

__all__ = ["CPUPlace", "CUDAPlace", "Executor", "ParamAttr", "Program",
           "Scope", "default_main_program", "default_startup_program",
           "disable_amp", "enable_amp", "global_scope", "layers",
           "optimizer", "program_guard", "resolve_device"]
