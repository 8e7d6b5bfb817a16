"""Fused attention op (counterpart of paddle_tpu/ops/attention_ops.py):
one op is one flash-attention call — the hand-written kernels on the card
(``kernels/flash_attention.py``), their plain versions on the CPU — with
key padding as per-row lengths instead of an additive bias."""

from __future__ import annotations

from ..core.registry import register_op
from ..kernels.flash_attention import flash_attention
from .common import in_desc, set_output


def _fused_attn_infer(op, block):
    q = in_desc(op, block, "Q")
    if q is not None:
        set_output(block, op, "Out", list(q.shape), q.dtype)


@register_op("fused_attention", infer_shape=_fused_attn_infer,
             diff_inputs=["Q", "K", "V"])
def _fused_attention(ctx, ins, attrs):
    klen = ins.get("KLengths", [None])[0]
    return {"Out": [flash_attention(
        ins["Q"][0], ins["K"][0], ins["V"][0],
        causal=bool(attrs.get("causal", False)),
        scale=attrs.get("scale") or None,
        k_lengths=None if klen is None else klen.reshape(-1))]}
