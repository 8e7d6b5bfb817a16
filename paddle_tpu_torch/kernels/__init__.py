"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and a launch counter.

| TPU kernel (paddle_tpu/kernels)                   | Port                   |
| ------------------------------------------------- | ---------------------- |
| flash_attention.py `_fwd_call` (with/without lse) | csrc/flash_fwd.cu      |
| flash_attention.py `_bwd_calls` dq and dkv        | csrc/flash_bwd.cu      |
| (both: fp32 and bf16 operands)                    | (`*_f32`, `*_bf16`)    |
| paged_attention.py `_paged_call`: Sq=1 and verify | csrc/paged_decode.cu   |
| (Sq>1, q_lengths), fp32 and int8 pages            | (four entries)         |
| conv_epilogue.py `_conv_stats_kernel_inpad` and   | csrc/conv_epilogue.cu  |
| `_conv_stats_kernel` (conv + channel stats)       | (`conv_stats_f32`)     |
| conv_epilogue.py `_bn_epilogue_kernel`            | csrc/conv_epilogue.cu  |
|                                                   | (`bn_epilogue_f32`)    |

Import the wrappers from their modules (``kernels.flash_attention``,
``kernels.paged_attention``, ``kernels.conv_epilogue``); this package
re-exports nothing, so a module name never resolves to a function of the
same name.
"""
