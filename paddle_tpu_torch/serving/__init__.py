"""Serving tier of the port (counterpart of paddle_tpu/serving): the paged
KV pool (fp32, bf16 or int8, refcounted pages), the prefix cache, and
greedy continuous-batching decode with greedy speculative decoding and
chunked prefill."""

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
    "SequenceHandle",
    "TransformerDecoder",
    "full_decode",
    "full_forward",
    "init_decode_params",
    "params_from_jax",
]
