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

| Linter corpus (paddle_tpu/analysis)               | Port                   |
| ------------------------------------------------- | ---------------------- |
| corpus.py `_broadcast_lse_operand` (row 8)        | csrc/corpus.cu         |
| (`_add_kernel`: x + b)                            | (`corpus_add_f32`)     |
| corpus.py `_vmem_overflow` (row 9)                | csrc/corpus.cu         |
| (`_scale_kernel`: 2x, a whole-block tile)         | (`corpus_scale_f32`)   |

Import the wrappers from their modules (``kernels.flash_attention``,
``kernels.paged_attention``, ``kernels.conv_epilogue``,
``kernels.corpus``, whose two ops are ``torch.library`` custom ops, so
the linter sees each launch in a captured graph); this package
re-exports nothing, so a module name never resolves to a function of the
same name.  ``kernels.counters`` reads and adds to every wrapper's launch
counters at once (a replayed CUDA graph launches without calling them).
"""
