"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` stays the reference; this package is its
counterpart for one NVIDIA Hopper card, built slice by slice.  Module
names mirror the JAX package (``kernels/flash_attention.py``,
``serving/kvcache.py``, ...) so each file's counterpart is easy to find.

The package imports ``torch`` and never ``jax`` or ``paddle_tpu``.  Every
Pallas kernel on a ported path is a CUDA C++ kernel written for
``sm_90a`` (``kernels/csrc``), compiled by ``nvcc`` at first use
(``kernels/_build.py``).  Entry points run on the card; a caller asks for
the CPU explicitly with ``device="cpu"``, where each kernel wrapper takes
its plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
