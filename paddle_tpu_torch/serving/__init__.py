"""Serving tier of the port (counterpart of paddle_tpu/serving): the paged
KV pool (fp32, bf16 or int8, refcounted pages), the prefix cache, and
continuous-batching decode, greedy or sampled per request (temperature,
top-k, top-p, logit bias, stop sequences, a per-request cap; JAX's own
(seed, token-index) stream), with speculative decoding verified by the
longest-prefix walk or the exact accept/resample epilogue, and chunked
prefill."""

from ..kernels.paged_attention import GroupedHeadsError
from .generate import (
    ContinuousBatchingLoop,
    DecodeConfig,
    DecodeRequest,
    GeneratedSequence,
    NonFiniteSequenceError,
    TransformerDecoder,
    full_decode,
    full_forward,
    init_decode_params,
    params_from_jax,
)
from .kvcache import KVCachePool, PagePoolExhausted, SequenceHandle
from .prefixcache import PrefixCache, PrefixMatch
from .sampling import (
    SamplingParams,
    apply_bias,
    sample_rows,
    spec_sample_rows,
    stop_hit,
)
from .speculative import PromptLookupDrafter

__all__ = [
    "ContinuousBatchingLoop",
    "DecodeConfig",
    "DecodeRequest",
    "GeneratedSequence",
    "GroupedHeadsError",
    "KVCachePool",
    "NonFiniteSequenceError",
    "PagePoolExhausted",
    "PrefixCache",
    "PrefixMatch",
    "PromptLookupDrafter",
    "SamplingParams",
    "SequenceHandle",
    "TransformerDecoder",
    "apply_bias",
    "full_decode",
    "full_forward",
    "init_decode_params",
    "params_from_jax",
    "sample_rows",
    "spec_sample_rows",
    "stop_hit",
]
