"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter.

| TPU kernel (paddle_tpu/kernels)                  | Port                    |
| ------------------------------------------------ | ----------------------- |
| flash_attention.py `_fwd_call` (with/without lse) | csrc/flash_fwd.cu       |
| flash_attention.py `_bwd_calls` dq and dkv       | csrc/flash_bwd.cu       |
| paged_attention.py `_paged_call` (Sq=1)          | csrc/paged_decode.cu    |

Import the wrappers from their modules (``kernels.flash_attention``,
``kernels.paged_attention``); this package re-exports nothing, so a
module name never resolves to a function of the same name.
"""
