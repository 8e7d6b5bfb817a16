"""Transformer NMT (counterpart of paddle_tpu/models/transformer.py): the
base Transformer (6+6 layers, d_model 512, 8 heads, ffn 2048, sinusoid
positions, label smoothing) built from the port's layers, so it trains
through ``optimizer.minimize`` and ``Executor.run``.

The builder makes the same layer calls in the same order as the JAX
package's, so both give the same ProgramDesc.  Ported is the path with
``use_flash_attention=True``: one ``fused_attention`` op per attention,
key padding as per-row lengths; with ``fuse_qkv`` one [d, 3d] projection
and a split for self-attention ([d, 2d] for cross-attention's k and v),
and with ``dropout > 0`` the dropout ops after the embeddings, the
attention output, the FFN's hidden layer and each sublayer's output.
Asking for a part that is not ported (the bias-tensor attention, the
unfused label-smoothing chain, recompute) raises NotImplementedError.
The serving decoder (``serving/generate.py``) reads ``_sinusoid_table``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .. import layers
from ..initializer import NumpyArrayInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .common import ModelSpec

__all__ = ["TransformerConfig", "transformer"]


@dataclasses.dataclass
class TransformerConfig:
    src_vocab_size: int = 10000
    trg_vocab_size: int = 10000
    max_length: int = 256
    n_layer: int = 6
    n_head: int = 8
    d_model: int = 512
    d_inner: int = 2048
    dropout: float = 0.1
    label_smooth_eps: float = 0.1
    pad_idx: int = 0
    # mesh axes the weights are annotated for (kept in the desc)
    tp_axis: str = "tp"
    shard_weights: bool = True
    use_flash_attention: bool = False
    fuse_qkv: bool = False
    use_recompute: bool = False
    fuse_smooth_ce: bool = True


def _sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    dim = np.arange(d_model // 2, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * dim / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def _check_ported(cfg: TransformerConfig) -> None:
    missing = [what for what, on in (
        ("use_flash_attention=False (the bias-tensor attention)",
         not cfg.use_flash_attention),
        ("use_recompute (recompute_scope)", cfg.use_recompute),
        ("fuse_smooth_ce=False (one_hot / label_smooth)",
         not cfg.fuse_smooth_ce)) if on]
    if missing:
        raise NotImplementedError("not ported: " + ", ".join(missing))


class _Builder:
    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def linear(self, x, d_in, d_out, name, shard=None, act=None, bias=True,
               initializer=None):
        cfg = self.cfg
        w = layers.create_parameter(
            [d_in, d_out], "float32",
            attr=ParamAttr(name=f"{name}_w", initializer=initializer))
        if cfg.shard_weights and shard is not None:
            w.sharding = shard
        out = layers.matmul(x, w)
        if bias:
            b = layers.create_parameter([d_out], "float32",
                                        attr=ParamAttr(name=f"{name}_b"),
                                        is_bias=True)
            out = layers.elementwise_add(out, b)
        if act == "relu":
            out = layers.relu(out)
        return out

    def mha(self, q_in, kv_in, name, k_lengths, causal=False):
        """Multi-head attention through one fused_attention op."""
        cfg = self.cfg
        d, h = cfg.d_model, cfg.n_head
        dh = d // h
        tp = cfg.tp_axis
        # a fused projection keeps the unfused per-projection Xavier scale
        # (fan_in = fan_out = d) and carries no tp annotation, as in
        # paddle_tpu/models/transformer.py
        proj_init = XavierInitializer(fan_in=d, fan_out=d)
        if cfg.fuse_qkv and q_in is kv_in:
            qkv = self.linear(q_in, d, 3 * d, f"{name}_qkv",
                              initializer=proj_init)
            q, k, v = layers.split(qkv, num_or_sections=3, dim=-1)
        elif cfg.fuse_qkv:
            q = self.linear(q_in, d, d, f"{name}_q", shard=[None, tp])
            kv = self.linear(kv_in, d, 2 * d, f"{name}_kv",
                             initializer=proj_init)
            k, v = layers.split(kv, num_or_sections=2, dim=-1)
        else:
            q = self.linear(q_in, d, d, f"{name}_q", shard=[None, tp])
            k = self.linear(kv_in, d, d, f"{name}_k", shard=[None, tp])
            v = self.linear(kv_in, d, d, f"{name}_v", shard=[None, tp])

        def split_heads(x):
            x = layers.reshape(x, shape=[0, 0, h, dh])
            return layers.transpose(x, perm=[0, 2, 1, 3])  # [B, H, S, dh]

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        ctx = layers.fused_attention(q, k, v, causal=causal,
                                     k_lengths=k_lengths)
        if cfg.dropout:
            # on the attention output: the kernel keeps no weights to drop
            ctx = layers.dropout(ctx, dropout_prob=cfg.dropout)
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
        ctx = layers.reshape(ctx, shape=[0, 0, d])
        return self.linear(ctx, d, d, f"{name}_o", shard=[tp, None])

    def ffn(self, x, name):
        cfg = self.cfg
        tp = cfg.tp_axis
        hidden = self.linear(x, cfg.d_model, cfg.d_inner, f"{name}_in",
                             shard=[None, tp], act="relu")
        if cfg.dropout:
            hidden = layers.dropout(hidden, dropout_prob=cfg.dropout)
        return self.linear(hidden, cfg.d_inner, cfg.d_model, f"{name}_out",
                           shard=[tp, None])

    def sublayer(self, x, out, name):
        """post-norm residual connection: LayerNorm(x + dropout(out))."""
        if self.cfg.dropout:
            out = layers.dropout(out, dropout_prob=self.cfg.dropout)
        return layers.layer_norm(
            layers.elementwise_add(x, out), begin_norm_axis=2,
            param_attr=ParamAttr(name=f"{name}_ln_scale"),
            bias_attr=ParamAttr(name=f"{name}_ln_bias"))

    def embed(self, words, vocab_size, name):
        """token embedding * sqrt(d) + sinusoid positions, then dropout."""
        cfg = self.cfg
        emb = layers.embedding(words, size=[vocab_size, cfg.d_model],
                               padding_idx=cfg.pad_idx,
                               param_attr=ParamAttr(name=f"{name}_emb"))
        emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
        seq_len = words.shape[1]
        pos_table = layers.create_parameter(
            [seq_len, cfg.d_model], "float32",
            attr=ParamAttr(
                name=f"{name}_pos_enc", trainable=False,
                initializer=NumpyArrayInitializer(
                    _sinusoid_table(cfg.max_length, cfg.d_model)[:seq_len])))
        out = layers.elementwise_add(emb, pos_table, axis=1)
        if cfg.dropout:
            out = layers.dropout(out, dropout_prob=cfg.dropout)
        return out

    def seq_lengths(self, words):
        """[B] count of non-pad tokens (key-padding lengths for flash)."""
        pad = layers.fill_constant_batch_size_like(
            words, shape=[-1, words.shape[1]], dtype="int64",
            value=self.cfg.pad_idx)
        not_pad = layers.cast(layers.not_equal(words, pad), "int32")
        return layers.reduce_sum(not_pad, dim=1)


def transformer(cfg: Optional[TransformerConfig] = None, src_word=None,
                trg_word=None, lbl_word=None) -> ModelSpec:
    cfg = cfg or TransformerConfig()
    _check_ported(cfg)
    S = cfg.max_length
    if src_word is None:
        src_word = layers.data("src_word", [S], dtype="int64")
    if trg_word is None:
        trg_word = layers.data("trg_word", [S], dtype="int64")
    if lbl_word is None:
        lbl_word = layers.data("lbl_word", [S], dtype="int64")

    b = _Builder(cfg)
    src_len = b.seq_lengths(src_word)
    trg_len = b.seq_lengths(trg_word)

    enc = b.embed(src_word, cfg.src_vocab_size, "src")
    for i in range(cfg.n_layer):
        attn = b.mha(enc, enc, f"enc_l{i}_attn", k_lengths=src_len)
        enc = b.sublayer(enc, attn, f"enc_l{i}_attn")
        ff = b.ffn(enc, f"enc_l{i}_ffn")
        enc = b.sublayer(enc, ff, f"enc_l{i}_ffn")

    dec = b.embed(trg_word, cfg.trg_vocab_size, "trg")
    for i in range(cfg.n_layer):
        self_attn = b.mha(dec, dec, f"dec_l{i}_self", k_lengths=trg_len,
                          causal=True)
        dec = b.sublayer(dec, self_attn, f"dec_l{i}_self")
        cross = b.mha(dec, enc, f"dec_l{i}_cross", k_lengths=src_len)
        dec = b.sublayer(dec, cross, f"dec_l{i}_cross")
        ff = b.ffn(dec, f"dec_l{i}_ffn")
        dec = b.sublayer(dec, ff, f"dec_l{i}_ffn")

    logits = b.linear(dec, cfg.d_model, cfg.trg_vocab_size, "project",
                      shard=[None, cfg.tp_axis], bias=False)

    # label-smoothed CE folded into the op, masked to non-pad targets
    cost = layers.softmax_with_cross_entropy(
        logits=logits, label=lbl_word, smooth_eps=cfg.label_smooth_eps)
    cost = layers.squeeze(cost, axes=[2])
    pad = layers.fill_constant_batch_size_like(
        lbl_word, shape=[-1, S], dtype="int64", value=cfg.pad_idx)
    non_pad = layers.cast(layers.not_equal(lbl_word, pad), "float32")
    token_count = layers.reduce_sum(non_pad)
    sum_cost = layers.reduce_sum(layers.elementwise_mul(cost, non_pad))
    avg_cost = layers.elementwise_div(sum_cost, token_count)

    def synthetic_batch(batch_size: int, seed: int = 0
                        ) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(seed)

        # no pad_idx in real positions; ragged tails padded with pad_idx
        def seqs():
            w = rng.randint(1, cfg.src_vocab_size, size=(batch_size, S))
            lens = rng.randint(S // 2, S + 1, size=(batch_size,))
            for r, n in zip(w, lens):
                r[n:] = cfg.pad_idx
            return w.astype(np.int64)

        return {src_word.name: seqs(), trg_word.name: seqs(),
                lbl_word.name: seqs()}

    return ModelSpec(
        name="transformer_base",
        feed_names=[src_word.name, trg_word.name, lbl_word.name],
        loss=avg_cost,
        metrics={"token_count": token_count, "sum_cost": sum_cost},
        synthetic_batch=synthetic_batch,
        extras={"logits": logits, "config": cfg})
