"""Greedy continuous-batching decode over the paged KV pool, with greedy
speculative decoding (counterpart of paddle_tpu/serving/generate.py,
the single-device greedy slice).

The model is the decoder half of the repo's Transformer: post-norm
residual blocks (LayerNorm(x + sublayer(x))), scaled embedding plus
sinusoid positions, tied input/output embeddings, no cross-attention.
:class:`TransformerDecoder` holds it as an ``nn.Module`` and runs the
serving steps:

- ``prefill_step``: ONE causal pass over a co-admitted group's prompts,
  padded to the group's longest and masked through ``k_lengths``; it
  writes every prompt token's K/V into the pool and returns the
  next-token logits after each prompt.  Attention is the flash kernel.
- ``decode_step``: one token per sequence; its K/V is appended to the
  pool and attention is the paged decode kernel over the page tables.
- ``verify_step``: a block of 1 + d tokens per sequence (the last
  committed token and d drafted ones) in one step; attention is the
  paged kernel's verify variant, each row causal inside the block.

Both steps take ``windows`` / ``sinks`` (the sliding-window + attention-
sink decode mask, per row) and ``table_block`` (two-level page tables);
with either, the kernel walks explicit page starts (``_step_tables``).

:class:`ContinuousBatchingLoop` keeps up to ``max_batch`` sequences in
flight.  Admission is reservation-based and FIFO (a request enters only
when the pool covers every admitted sequence's worst case), each
admitted group gets one batched prefill, decoding is greedy argmax, and
a sequence retires on ``eos_id`` or ``max_new_tokens`` and returns its
pages.  With ``speculate=d`` each decoding sequence drafts up to d
tokens by prompt lookup (``speculative.PromptLookupDrafter``), one
verify step checks every block, the longest prefix the model agrees
with is committed, and ``pool.truncate_seq`` rolls the rejected tokens
back.  A non-finite logits row quarantines only its own sequence; any
exception out of a step frees every stepping sequence's pages before it
propagates.  Both steps pass an int8 pool's per-page scales to the
kernel.  A request with ``window=`` decodes under the sliding window
(plus ``sinks`` tokens' pages); before each decode step the loop evicts
the pages that window can never attend again, so a long context's walk
stays at sinks + window pages.  ``table_block=`` sends every decode and
verify step's tables through the two-level view.

``full_forward`` / ``full_decode`` are the oracles: per-sequence greedy
decode recomputing the whole prefix with plain attention and no cache,
under ``window_mask`` for windowed decode.

Left for later slices: sampling and sampled speculation, the prefix
cache with chunked prefill (and with it the corpus drafter), adapters,
bf16 pools, SPMD programs, the tiered KV store and the Engine front end.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.flash_attention import (
    NEG_INF,
    flash_attention,
    reference_attention,
)
from ..kernels.paged_attention import (
    PAD_START,
    TwoLevelTables,
    _group_size,
    paged_decode_attention,
    repeat_kv,
)
from ..models.transformer import _sinusoid_table
from .kvcache import KVCachePool, PagePoolExhausted
from .speculative import PromptLookupDrafter

__all__ = [
    "ContinuousBatchingLoop",
    "DecodeConfig",
    "DecodeRequest",
    "GeneratedSequence",
    "NonFiniteSequenceError",
    "TransformerDecoder",
    "full_decode",
    "full_forward",
    "init_decode_params",
    "params_from_jax",
    "window_mask",
]

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1_g", "ln1_b", "w1", "b1", "w2",
               "b2", "ln2_g", "ln2_b")


class NonFiniteSequenceError(RuntimeError):
    """One sequence's logits went non-finite: that sequence was
    quarantined — evicted from the batch, its pages scrubbed and freed —
    while its batch-mates decode on."""

    def __init__(self, seq_id: int, step: int):
        self.seq_id = seq_id
        self.step = step
        super().__init__(
            f"sequence {seq_id} produced non-finite logits at loop step "
            f"{step}; it was evicted from the batch (pages freed) and "
            "its batch-mates decoded on")

    def __reduce__(self):
        return (type(self), (self.seq_id, self.step))


@dataclasses.dataclass
class DecodeConfig:
    """Decoder-only slice of the repo's TransformerConfig.

    ``n_kv_head`` (None: n_head) enables grouped-query attention.  As in
    the JAX package, validation is lazy: ``head_dim`` raises ValueError
    when d_model does not divide by n_head, and ``num_kv_heads`` raises
    GroupedHeadsError when n_head is not a multiple of n_kv_head."""

    vocab_size: int = 128
    d_model: int = 32
    n_head: int = 4
    n_layer: int = 2
    d_inner: int = 64
    max_length: int = 96
    eos_id: Optional[int] = None  # None: sequences retire on max_new only
    n_kv_head: Optional[int] = None  # None: n_head (no grouping)

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_head:
            raise ValueError("d_model must divide by n_head")
        return self.d_model // self.n_head

    @property
    def num_kv_heads(self) -> int:
        h_kv = self.n_kv_head if self.n_kv_head is not None else self.n_head
        _group_size(self.n_head, h_kv)  # typed GroupedHeadsError raise
        return h_kv

    @property
    def group_size(self) -> int:
        """Query heads per KV head (1 without grouping)."""
        return self.n_head // self.num_kv_heads


def init_decode_params(cfg: DecodeConfig, seed: int = 0) -> Dict:
    """Deterministic fp32 params; weights at 1/sqrt(fan_in) scale.  The
    same numpy stream as the JAX package: one seed gives both packages
    identical weights."""
    rng = np.random.RandomState(seed)

    def mat(d_in, d_out):
        return (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
            np.float32)

    d, f = cfg.d_model, cfg.d_inner
    d_kv = cfg.num_kv_heads * cfg.head_dim  # K/V project to H_kv heads
    layers = []
    for _ in range(cfg.n_layer):
        layers.append({
            "wq": mat(d, d), "wk": mat(d, d_kv), "wv": mat(d, d_kv),
            "wo": mat(d, d),
            "ln1_g": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "w1": mat(d, f), "b1": np.zeros(f, np.float32),
            "w2": mat(f, d), "b2": np.zeros(d, np.float32),
            "ln2_g": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
        })
    return {
        "embed": (rng.standard_normal((cfg.vocab_size, d)) / np.sqrt(d)
                  ).astype(np.float32),
        "pos": _sinusoid_table(cfg.max_length, d),
        "layers": layers,
    }


def params_from_jax(params: Dict, device=None) -> Dict:
    """The JAX package's params dict (numpy or jax arrays, as its
    ``init_decode_params`` returns them) -> the same nested dict of fp32
    torch tensors on ``device`` (None: the card).  Tensors pass through,
    moved to the device."""
    dev = resolve_device(device)

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return {"embed": t(params["embed"]), "pos": t(params["pos"]),
            "layers": [{k: t(lp[k]) for k in _LAYER_KEYS}
                       for lp in params["layers"]]}


def _layernorm(x, g, b, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g + b


def _ffn_block(h, lp):
    u = torch.relu(h @ lp["w1"] + lp["b1"])
    return _layernorm(h + (u @ lp["w2"] + lp["b2"]), lp["ln2_g"], lp["ln2_b"])


def _forward_hidden(st: Dict, cfg: DecodeConfig, tokens,
                    mask=None) -> torch.Tensor:
    """The oracle's last hidden states [S, d] on the params' device;
    ``mask`` ([S, S] bool, query x key) replaces the causal mask."""
    dev = st["embed"].device
    tokens = np.asarray(tokens, np.int64)
    S = tokens.shape[0]
    if S > cfg.max_length:
        raise ValueError(f"sequence length {S} > max_length {cfg.max_length}")
    d, H, Dh = cfg.d_model, cfg.n_head, cfg.head_dim
    Hkv, G = cfg.num_kv_heads, cfg.group_size
    if mask is not None:
        mask = torch.as_tensor(np.asarray(mask, bool), device=dev)
    tok = torch.as_tensor(tokens, device=dev)
    h = st["embed"][tok] * float(np.sqrt(d)) + st["pos"][:S]
    for lp in st["layers"]:
        q = (h @ lp["wq"]).reshape(S, H, Dh).transpose(0, 1)[None]
        k = (h @ lp["wk"]).reshape(S, Hkv, Dh).transpose(0, 1)[None]
        v = (h @ lp["wv"]).reshape(S, Hkv, Dh).transpose(0, 1)[None]
        k, v = repeat_kv(k, v, G)
        if mask is None:
            attn = reference_attention(q, k, v, causal=True, scale=Dh ** -0.5)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * Dh ** -0.5
            scores = scores.masked_fill(~mask, NEG_INF)
            attn = torch.matmul(torch.softmax(scores, dim=-1), v)
        attn = attn[0].transpose(0, 1).reshape(S, d)
        h = _layernorm(h + attn @ lp["wo"], lp["ln1_g"], lp["ln1_b"])
        h = _ffn_block(h, lp)
    return h


@torch.inference_mode()
def full_forward(params: Dict, cfg: DecodeConfig, tokens, device=None,
                 mask=None) -> np.ndarray:
    """Oracle forward: full-sequence causal attention (plain PyTorch), no
    cache.  tokens [S] int -> logits [S, V] numpy.  ``mask`` (optional
    [S, S] bool, query x key) replaces the causal mask: the windowed
    oracle passes :func:`window_mask`."""
    st = params_from_jax(params, device)
    h = _forward_hidden(st, cfg, tokens, mask)
    return (h @ st["embed"].T).cpu().numpy()


def window_mask(S: int, prompt_len: int, window: int, sinks: int,
                page_size: int) -> np.ndarray:
    """The [S, S] query x key visibility of windowed decode, the rule the
    kernel's page mask, the pool's eviction and the oracle share:

    - prompt queries (position < prompt_len) attend fully causal, since
      prefill is full attention;
    - a decode query at position p sees key j iff ``j <= p`` and j's page
      (start ``(j // page_size) * page_size``) is a sink page (start <
      sinks) or overlaps the trailing window (start + page_size > p + 1 -
      window).

    Page-granular, as the kernel decides visibility per page start and
    the pool drops exactly the pages this mask can never light again."""
    if window < 1:
        raise ValueError(f"window must be >= 1 token, got {window}")
    j = np.arange(S)
    p = np.arange(S)[:, None]
    page_start = (j // page_size) * page_size
    return (j[None, :] <= p) & (
        (p < prompt_len)
        | (page_start[None, :] < sinks)
        | (page_start[None, :] + page_size > p + 1 - window))


@torch.inference_mode()
def full_decode(params: Dict, cfg: DecodeConfig, prompt: Sequence[int],
                max_new_tokens: int, device=None,
                window: Optional[int] = None, sinks: int = 0,
                page_size: int = 1) -> Tuple[List[int], List[np.ndarray]]:
    """Greedy per-sequence decode, recomputing the full prefix each token.
    Returns (generated tokens, the [V] logits row behind each).
    ``window`` / ``sinks`` / ``page_size`` apply the page-granular
    sliding-window + attention-sink decode mask (:func:`window_mask`)."""
    st = params_from_jax(params, device)
    tokens = [int(t) for t in prompt]
    out: List[int] = []
    rows: List[np.ndarray] = []
    for _ in range(max_new_tokens):
        mask = (window_mask(len(tokens), len(prompt), window, sinks,
                            page_size) if window is not None else None)
        h_last = _forward_hidden(st, cfg, tokens, mask)[-1]
        row = (h_last @ st["embed"].T).cpu().numpy()
        nxt = int(row.argmax())
        rows.append(row)
        out.append(nxt)
        tokens.append(nxt)
        if cfg.eos_id is not None and nxt == cfg.eos_id:
            break
    return out, rows


def _step_tables(pool: KVCachePool, seq_ids: Sequence[int], windows, sinks,
                 table_block: Optional[int]):
    """One step's page-table view and windowing operands: (tables,
    lengths, kw), where tables is a flat [B, max_pages] array or a
    TwoLevelTables and kw the extra keywords of paged_decode_attention.
    A windowed flat view carries explicit page starts (an evicted
    table's pages no longer sit at ``i * page_size``); a TwoLevelTables
    always carries its starts."""
    kw = {}
    if windows is not None:
        kw["windows"] = np.asarray(windows, np.int32)
        kw["sinks"] = (np.asarray(sinks, np.int32) if sinks is not None
                       else np.zeros(len(seq_ids), np.int32))
    if table_block:
        tables, lengths = pool.two_level_tables(seq_ids, table_block)
    elif windows is not None:
        tables, kw["page_starts"], lengths = pool.page_tables_with_starts(
            seq_ids)
    else:
        tables, lengths = pool.page_table_batch(seq_ids)
    return tables, lengths, kw


class _DecoderLayer(nn.Module):
    def __init__(self, d: int, d_kv: int, f: int, device):
        super().__init__()
        shapes = {"wq": (d, d), "wk": (d, d_kv), "wv": (d, d_kv),
                  "wo": (d, d), "ln1_g": (d,), "ln1_b": (d,), "w1": (d, f),
                  "b1": (f,), "w2": (f, d), "b2": (d,), "ln2_g": (d,),
                  "ln2_b": (d,)}
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape, device=device))

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in _LAYER_KEYS}


class TransformerDecoder(nn.Module):
    """The serving decoder as an ``nn.Module`` of fp32 buffers on
    ``device`` (None: the card).  Weights start at zero; load them with
    :meth:`load_jax_params`.  ``attend_prefill``, ``attend_decode`` and
    ``attend_verify`` are the attention calls the steps make — the flash
    kernel and the paged kernel's decode and verify variants; ``walk``
    carries the long-context keywords (``page_starts``, ``windows``,
    ``sinks``) and ``tables`` may then be a TwoLevelTables."""

    def __init__(self, cfg: DecodeConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        d, f = cfg.d_model, cfg.d_inner
        d_kv = cfg.num_kv_heads * cfg.head_dim
        self.register_buffer(
            "embed", torch.zeros(cfg.vocab_size, d, device=self.device))
        self.register_buffer(
            "pos", torch.zeros(cfg.max_length, d, device=self.device))
        self.layers = nn.ModuleList(
            _DecoderLayer(d, d_kv, f, self.device) for _ in range(cfg.n_layer))

    @torch.no_grad()
    def load_jax_params(self, params: Dict) -> "TransformerDecoder":
        """Copy a JAX-layout params dict (see :func:`params_from_jax`) into
        the module's buffers; shapes must match the config."""
        st = params_from_jax(params, self.device)
        if len(st["layers"]) != len(self.layers):
            raise ValueError(f"params carry {len(st['layers'])} layers, the "
                             f"config {len(self.layers)}")
        self.embed.copy_(st["embed"])
        self.pos.copy_(st["pos"])
        for layer, lp in zip(self.layers, st["layers"]):
            for k in _LAYER_KEYS:
                getattr(layer, k).copy_(lp[k])
        return self

    def _index(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).long()

    def attend_prefill(self, q, k, v, lens) -> torch.Tensor:
        """Causal ragged attention over [B, H, S, D] (flash kernel)."""
        return flash_attention(q, k, v, causal=True,
                               scale=self.cfg.head_dim ** -0.5, k_lengths=lens)

    def attend_decode(self, q, k_pages, v_pages, tables, lengths,
                      k_scales=None, v_scales=None, **walk) -> torch.Tensor:
        """Sq=1 attention over one layer of the pool (paged kernel,
        decode variant; scales for an int8 pool)."""
        return paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                                      scale=self.cfg.head_dim ** -0.5,
                                      k_scales=k_scales, v_scales=v_scales,
                                      **walk)

    def attend_verify(self, q, k_pages, v_pages, tables, lengths,
                      q_lengths, k_scales=None, v_scales=None, **walk
                      ) -> torch.Tensor:
        """Multi-token attention over one layer of the pool, q [B, H, Sq,
        D] with ragged ``q_lengths`` (paged kernel, verify variant)."""
        return paged_decode_attention(q, k_pages, v_pages, tables, lengths,
                                      scale=self.cfg.head_dim ** -0.5,
                                      q_lengths=q_lengths,
                                      k_scales=k_scales, v_scales=v_scales,
                                      **walk)

    def _tables(self, pool, seq_ids, windows, sinks, table_block):
        """_step_tables with every array on the model's device, copied
        once a step rather than once a layer."""
        tables, lengths, walk = _step_tables(pool, seq_ids, windows, sinks,
                                             table_block)
        dev = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        if isinstance(tables, TwoLevelTables):
            tables = TwoLevelTables(dev(tables.l1), dev(tables.l2),
                                    dev(tables.starts), tables.block_size)
        else:
            tables = dev(tables)
        return tables, dev(lengths), {k: dev(a) for k, a in walk.items()}

    @torch.inference_mode()
    def decode_step(self, pool: KVCachePool, seq_ids: Sequence[int],
                    tokens, positions, windows=None, sinks=None,
                    table_block: Optional[int] = None) -> torch.Tensor:
        """Feed token[i] at position[i] for every sequence, append its K/V
        to the pool, and return the next-token logits [B, V].
        ``windows`` / ``sinks`` ([B]; a row without a window passes
        PAD_START / 0) apply the window + sink decode mask; ``table_block``
        walks two-level tables."""
        cfg = self.cfg
        B = len(seq_ids)
        d, H, Dh, Hkv = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.num_kv_heads
        h = self.embed[self._index(tokens)] * float(np.sqrt(d)) \
            + self.pos[self._index(positions)]
        pages, slots = pool.append_token(seq_ids)
        tables, lengths, walk = self._tables(pool, seq_ids, windows, sinks,
                                             table_block)
        for li, layer in enumerate(self.layers):
            lp = layer.params()
            q = (h @ lp["wq"]).reshape(B, H, Dh)
            k = (h @ lp["wk"]).reshape(B, Hkv, Dh)
            v = (h @ lp["wv"]).reshape(B, Hkv, Dh)
            pool.write_kv(li, pages, slots, k, v)
            k_scales, v_scales = pool.layer_scales(li)
            attn = self.attend_decode(q[:, :, None, :], pool.k_pages[li],
                                      pool.v_pages[li], tables, lengths,
                                      k_scales, v_scales, **walk)
            attn = attn[:, :, 0, :].reshape(B, d)
            h = _layernorm(h + attn @ lp["wo"], lp["ln1_g"], lp["ln1_b"])
            h = _ffn_block(h, lp)
        return h @ self.embed.T

    @torch.inference_mode()
    def verify_step(self, pool: KVCachePool, seq_ids: Sequence[int],
                    blocks: Sequence[Sequence[int]],
                    start_positions: Sequence[int],
                    pad_to: Optional[int] = None, windows=None, sinks=None,
                    table_block: Optional[int] = None) -> torch.Tensor:
        """One speculative verify step: sequence i feeds ``blocks[i]`` —
        its last committed token plus d_i drafted ones — from absolute
        position ``start_positions[i]``, appends every fed token's K/V to
        the pool in ONE atomic ``append_tokens`` claim, and returns the
        logits [B, Sq, V] at every fed position: row t predicts the token
        at position start+t+1, which draft token t+1 claims to be.  Sq is
        the longest block, or ``pad_to``.  Rows past ``len(blocks[i])``
        are padding the caller ignores.  A block of length 1 computes
        what ``decode_step`` computes for that sequence.

        The JAX step pads its K/V scatter to B * Sq rows and its tables to
        a multiple of 8 pages, so that XLA compiles each shape once;
        eager torch has no such cost, and this step writes only the valid
        rows and passes the tables as they are.  The caller owns
        acceptance and rollback (``pool.truncate_seq``).  ``windows``,
        ``sinks`` and ``table_block`` as in :meth:`decode_step`."""
        cfg = self.cfg
        lens = np.asarray([len(b) for b in blocks], np.int32)
        if not len(lens) or lens.min() < 1:
            raise ValueError("verify needs >= 1 fed token per sequence")
        starts = np.asarray(start_positions, np.int64)
        B, Sq = len(blocks), int(lens.max())
        if pad_to is not None:
            if pad_to < Sq:
                raise ValueError(f"pad_to {pad_to} < longest block {Sq}")
            Sq = int(pad_to)
        if int((starts + lens).max()) > cfg.max_length:
            # before append_tokens: a failed verify must not leave claimed
            # slots with no K/V behind
            raise ValueError(
                f"verify block reaches position {int((starts + lens).max())}"
                f" > max_length {cfg.max_length}")
        d, H, Dh, Hkv = cfg.d_model, cfg.n_head, cfg.head_dim, cfg.num_kv_heads
        tokens = np.zeros((B, Sq), np.int64)
        for i, blk in enumerate(blocks):
            tokens[i, :lens[i]] = blk
        pages, slots = pool.append_tokens(seq_ids, lens)
        tables, lengths, walk = self._tables(pool, seq_ids, windows, sinks,
                                             table_block)
        q_lengths = torch.as_tensor(lens, device=self.device)
        b_idx = self._index(np.repeat(np.arange(B), lens))
        t_idx = self._index(np.concatenate([np.arange(n) for n in lens]))
        # padded rows: positions clamped, their values unread
        pos = np.minimum(starts[:, None] + np.arange(Sq)[None, :],
                         cfg.max_length - 1)
        h = self.embed[self._index(tokens)] * float(np.sqrt(d)) \
            + self.pos[self._index(pos)]  # [B, Sq, d]
        for li, layer in enumerate(self.layers):
            lp = layer.params()
            q = (h @ lp["wq"]).reshape(B, Sq, H, Dh)
            k = (h @ lp["wk"]).reshape(B, Sq, Hkv, Dh)
            v = (h @ lp["wv"]).reshape(B, Sq, Hkv, Dh)
            # valid rows only ([T, H_kv, Dh] in claim order)
            pool.write_kv(li, pages, slots, k[b_idx, t_idx], v[b_idx, t_idx])
            k_scales, v_scales = pool.layer_scales(li)
            attn = self.attend_verify(
                q.transpose(1, 2).contiguous(), pool.k_pages[li],
                pool.v_pages[li], tables, lengths, q_lengths, k_scales,
                v_scales, **walk)  # [B, H, Sq, Dh]
            attn = attn.transpose(1, 2).reshape(B, Sq, d)
            h = _layernorm(h + attn @ lp["wo"], lp["ln1_g"], lp["ln1_b"])
            h = _ffn_block(h, lp)
        return h @ self.embed.T

    @torch.inference_mode()
    def prefill_step(self, pool: KVCachePool, seq_ids: Sequence[int],
                     prompts: Sequence[Sequence[int]]) -> torch.Tensor:
        """Batched whole-prompt prefill: one causal pass over every prompt
        (padded to the longest, masked through k_lengths) writes each
        prompt token's K/V into the pool and returns the logits [B, V]
        after each prompt.  Padded rows compute values nobody reads:
        attention masks them as keys, their K/V is never written, and the
        returned row is taken at each sequence's true last position."""
        cfg = self.cfg
        lens = np.asarray([len(p) for p in prompts], np.int32)
        if not len(lens) or lens.min() < 1:
            raise ValueError("prefill needs non-empty prompts")
        B, Smax = len(prompts), int(lens.max())
        if Smax > cfg.max_length:
            # before append_tokens: a failed prefill must not leave claimed
            # slots with no K/V behind
            raise ValueError(
                f"prompt length {Smax} > max_length {cfg.max_length}")
        d, H, Dh = cfg.d_model, cfg.n_head, cfg.head_dim
        Hkv, G = cfg.num_kv_heads, cfg.group_size
        tokens = np.zeros((B, Smax), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :lens[i]] = p
        # flat (sequence order, token order) claim — matches append_tokens
        pages, slots = pool.append_tokens(seq_ids, lens)
        b_idx = self._index(np.repeat(np.arange(B), lens))
        t_idx = self._index(np.concatenate([np.arange(n) for n in lens]))
        klen = torch.as_tensor(lens, device=self.device)

        h = self.embed[self._index(tokens)] * float(np.sqrt(d)) \
            + self.pos[None, :Smax]  # [B, Smax, d]
        for li, layer in enumerate(self.layers):
            lp = layer.params()
            q = (h @ lp["wq"]).reshape(B, Smax, H, Dh)
            k = (h @ lp["wk"]).reshape(B, Smax, Hkv, Dh)
            v = (h @ lp["wv"]).reshape(B, Smax, Hkv, Dh)
            # valid tokens only ([T, H_kv, Dh] rows in claim order)
            pool.write_kv(li, pages, slots, k[b_idx, t_idx], v[b_idx, t_idx])
            kh, vh = repeat_kv(k.transpose(1, 2), v.transpose(1, 2), G)
            attn = self.attend_prefill(q.transpose(1, 2).contiguous(),
                                       kh.contiguous(), vh.contiguous(), klen)
            attn = attn.transpose(1, 2).reshape(B, Smax, d)
            h = _layernorm(h + attn @ lp["wo"], lp["ln1_g"], lp["ln1_b"])
            h = _ffn_block(h, lp)
        # true last positions: int64 indices on the model's device
        h_last = h[torch.arange(B, device=self.device), self._index(lens - 1)]
        return h_last @ self.embed.T


@dataclasses.dataclass
class DecodeRequest:
    """One request.  ``window`` (None: full attention) makes its decode
    attend only the pages that overlap the last ``window`` tokens, plus
    the pages of its first ``sinks`` tokens (attention sinks); prefill
    stays full attention.  The loop evicts the pages that mask can never
    light again, and the output is token-identical to ``full_decode``
    under the same ``window_mask``."""

    prompt: Sequence[int]
    max_new_tokens: int
    window: Optional[int] = None
    sinks: int = 0


@dataclasses.dataclass
class GeneratedSequence:
    """One finished sequence: generated tokens and the logits row behind
    each (the parity surface against full_decode), plus latency.
    ``error`` is a NonFiniteSequenceError when the sequence was
    quarantined; its tokens then stop at the last finite step."""

    seq_id: int
    prompt: List[int]
    tokens: List[int] = dataclasses.field(default_factory=list)
    logits: List[np.ndarray] = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0
    ttft_s: Optional[float] = None
    finished_at: float = 0.0
    error: Optional[Exception] = None


class _Active:
    __slots__ = ("req", "seq_id", "pos", "result", "charged")

    def __init__(self, req: DecodeRequest, seq_id: int,
                 result: GeneratedSequence, charged: int):
        self.req = req
        self.seq_id = seq_id
        self.pos = 0  # next position to feed
        self.result = result
        self.charged = charged  # pages this admission reserved


class ContinuousBatchingLoop:
    """Admit-as-they-retire greedy decode over one KVCachePool.

    ``params`` is a JAX-layout params dict (loaded into a
    :class:`TransformerDecoder` on ``device``) or a TransformerDecoder
    already on that device.  ``device=None`` is the card (raises without
    one); the pool must live on the same device.

    Admission is reservation-based: a request is admitted only when the
    pool covers every admitted sequence's worst-case footprint
    (ceil((len(prompt)+max_new)/page_size) pages), so no append can fail
    mid-decode; waiting requests admit in FIFO order as retirements free
    pages.  Each co-admitted group runs ONE ``prefill_step``; the loop
    then re-admits before decoding.

    ``speculate=d`` (0: off) arms greedy speculative decoding: each
    decoding sequence drafts up to min(d, its remaining max_new) tokens
    with ``drafter`` (None: a ``PromptLookupDrafter(max_draft=d)``; a
    drafter with ``stateful`` set gets ``seq_id=`` and a ``release`` on
    retirement and quarantine); when any block is longer than one token
    the step is a ``verify_step``, and each sequence commits the longest
    prefix of its draft that the model's argmax agrees with, plus the
    model's own next token, honouring EOS and max_new inside the block;
    the rejected tokens leave the pool through ``truncate_seq``.  Greedy
    output is token-identical to unspeculated decode.

    Requests with ``window=`` decode under the window + sink mask: a
    step whose batch holds a generating windowed sequence passes per-row
    windows and sinks (PAD_START / 0 for the others), and before each
    decode step every generating windowed sequence's dead interior pages
    are evicted.  ``table_block=b`` (None: flat tables) walks every
    decode and verify step's tables through the two-level view with L2
    blocks of b pages.

    Counters: ``steps``, ``prefill_steps``, ``decode_steps`` (verify
    steps included), ``spec_steps`` (verify steps), ``drafted_tokens``,
    ``accepted_tokens``, ``rolled_back_tokens``, ``quarantined``,
    ``pages_evicted``, ``max_decode_table_pages`` (the widest table any
    decode or verify step walked, after its eviction and appends);
    host-clock durations of each step (ending after the logits reach the
    host) in ``prefill_step_s``, ``decode_step_s`` and
    ``verify_step_s``."""

    def __init__(self, params: Union[Dict, TransformerDecoder],
                 cfg: DecodeConfig, pool: KVCachePool, max_batch: int = 4,
                 device=None, speculate: int = 0, drafter=None,
                 table_block: Optional[int] = None):
        if int(speculate) < 0:
            raise ValueError("speculate must be >= 0")
        if table_block is not None and int(table_block) < 1:
            raise ValueError("table_block must be >= 1 (or None)")
        self.device = resolve_device(device)
        if pool.device != self.device:
            raise ValueError(f"pool lives on {pool.device}, the loop runs "
                             f"on {self.device}")
        if pool.num_kv_heads != cfg.num_kv_heads:
            raise ValueError(
                f"pool holds {pool.num_kv_heads} KV heads but the model "
                f"projects {cfg.num_kv_heads} (cfg.n_kv_head)")
        if isinstance(params, TransformerDecoder):
            if params.device != self.device:
                raise ValueError(f"model lives on {params.device}, the loop "
                                 f"runs on {self.device}")
            self.model = params
        else:
            self.model = TransformerDecoder(cfg, self.device)
            self.model.load_jax_params(params)
        self.cfg = cfg
        self.pool = pool
        self.max_batch = int(max_batch)
        self._speculate = int(speculate)
        self._table_block = int(table_block) if table_block else None
        self.drafter = drafter if drafter is not None else (
            PromptLookupDrafter(max_draft=self._speculate)
            if self._speculate else None)
        self._next_seq_id = 0
        self.steps = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self.quarantined = 0
        self.spec_steps = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rolled_back_tokens = 0
        self.pages_evicted = 0
        self.max_decode_table_pages = 0
        self.prefill_step_s: List[float] = []
        self.decode_step_s: List[float] = []
        self.verify_step_s: List[float] = []

    def acceptance_rate(self) -> float:
        """Accepted / drafted tokens (0.0 before any draft)."""
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    def _spec_room(self, a: "_Active") -> int:
        """Draft tokens sequence `a` may carry this step: the loop's d,
        capped by its remaining max_new headroom — so the fed block never
        passes the worst case its admission reserved."""
        if not self._speculate:
            return 0
        return min(self._speculate,
                   a.req.max_new_tokens - len(a.result.tokens))

    def _draft_block(self, a: "_Active") -> List[int]:
        """The last committed token plus the drafter's proposal, clamped
        to the room (a drafter that ignores its limit must not pass the
        reservation)."""
        blk = [a.result.tokens[-1]]
        room = self._spec_room(a)
        if room > 0 and self.drafter is not None:
            ctx = list(a.result.prompt) + a.result.tokens
            if getattr(self.drafter, "stateful", False):
                proposal = self.drafter.draft(ctx, room, seq_id=a.seq_id)
            else:
                proposal = self.drafter.draft(ctx, room)
            blk += [int(t) for t in list(proposal)[:room]]
        return blk

    def _release_draft(self, a: "_Active") -> None:
        if getattr(self.drafter, "stateful", False):
            self.drafter.release(a.seq_id)

    def _footprint(self, req: DecodeRequest) -> int:
        """Worst-case pages a request pulls from the free list."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_length:
            raise ValueError(f"prompt+max_new={total} exceeds max_length "
                             f"{self.cfg.max_length}")
        return KVCachePool.pages_needed(total, self.pool.page_size)

    def run(self, requests: Sequence[DecodeRequest]
            ) -> List[GeneratedSequence]:
        waiting: List[Tuple[DecodeRequest, GeneratedSequence]] = []
        results: List[GeneratedSequence] = []
        for req in requests:
            if not len(req.prompt):
                raise ValueError("empty prompt")
            if req.window is not None and req.window < 1:
                raise ValueError(
                    f"window must be >= 1 token, got {req.window}")
            if req.sinks < 0:
                raise ValueError(f"sinks must be >= 0, got {req.sinks}")
            if req.sinks and req.window is None:
                raise ValueError(
                    "sinks without a window has no meaning — sink pages "
                    "are the exception to a window's eviction")
            # validate EVERY request before any work: a mid-run raise
            # would strand pages and drop finished sequences' results
            need = self._footprint(req)
            if need > self.pool.num_pages:
                raise PagePoolExhausted(
                    f"request needs {need} pages worst-case but the pool "
                    f"has {self.pool.num_pages} total")
            seq = GeneratedSequence(seq_id=-1,
                                    prompt=[int(t) for t in req.prompt])
            results.append(seq)
            waiting.append((req, seq))
        active: List[_Active] = []
        reserved_pages = 0

        def quarantine(batch: List[_Active], logits: torch.Tensor,
                       step_idx: int) -> Tuple[np.ndarray, set, float]:
            """One host copy of the step's logits; every non-finite row's
            sequence is scrubbed, freed and failed.  Returns (host logits,
            surviving row indices, post-sync step-end time)."""
            nonlocal reserved_pages
            host = logits.float().cpu().numpy()
            now = time.perf_counter()  # after the sync: true step end
            # every axis but the batch axis: [B, V] and verify's [B, Sq, V]
            finite = np.isfinite(host.reshape(len(batch), -1)).all(axis=1)
            for i in np.flatnonzero(~finite):
                a = batch[i]
                self.pool.scrub_seq_pages(a.seq_id)
                self.pool.free_seq(a.seq_id)
                self._release_draft(a)
                active.remove(a)
                a.result.error = NonFiniteSequenceError(a.seq_id, step_idx)
                a.result.finished_at = now
                reserved_pages -= a.charged
                self.quarantined += 1
            return host, set(np.flatnonzero(finite).tolist()), now

        def emit(a: _Active, row: np.ndarray, now: float,
                 tok: Optional[int] = None) -> bool:
            """Record one token (None: the greedy argmax of ``row``); True
            when the sequence is done — checked after every token, so an
            EOS inside an accepted draft block retires it there."""
            if tok is None:
                tok = int(row.argmax())
            a.result.tokens.append(tok)
            a.result.logits.append(row)
            if a.result.ttft_s is None:
                a.result.ttft_s = now - a.result.admitted_at
            return (len(a.result.tokens) >= a.req.max_new_tokens
                    or (self.cfg.eos_id is not None
                        and tok == self.cfg.eos_id))

        def retire(done: List[_Active], now: float) -> None:
            nonlocal reserved_pages
            for a in done:
                active.remove(a)
                a.result.finished_at = now
                self.pool.free_seq(a.seq_id)
                self._release_draft(a)
                reserved_pages -= a.charged

        def window_args(batch: List[_Active]):
            """The step's (windows, sinks) [B] int32 operands, or (None,
            None) when no row is a generating windowed sequence (a
            prompt position rides full attention: PAD_START / 0)."""
            rows = [a.req.window is not None
                    and a.pos >= len(a.result.prompt) for a in batch]
            if not any(rows):
                return None, None
            win = np.full(len(batch), PAD_START, np.int32)
            snk = np.zeros(len(batch), np.int32)
            for i, a in enumerate(batch):
                if rows[i]:
                    win[i], snk[i] = a.req.window, a.req.sinks
            return win, snk

        def evict_windowed(batch: List[_Active]) -> None:
            """Drop every generating windowed sequence's dead interior
            pages before the step's appends: window_mask is monotone in
            the query position, so a page it hides now stays hidden."""
            for a in batch:
                if a.req.window is not None \
                        and a.pos >= len(a.result.prompt):
                    self.pages_evicted += self.pool.evict_interior(
                        a.seq_id, a.req.window, a.req.sinks)

        def walk_args(batch: List[_Active]) -> Dict:
            """The step's long-context keywords, only those in use (a
            full-attention flat step calls the steps as before)."""
            win, snk = window_args(batch)
            kw = {} if win is None else dict(windows=win, sinks=snk)
            if self._table_block:
                kw["table_block"] = self._table_block
            return kw

        def verify(batch: List[_Active], blocks: List[List[int]],
                   t0: float, step_idx: int) -> None:
            """One verify step over every sequence's block, then the
            acceptance walk and rollback of each."""
            logits3 = self.model.verify_step(
                self.pool, [a.seq_id for a in batch], blocks,
                [a.pos for a in batch], pad_to=self._speculate + 1,
                **walk_args(batch))
            self.max_decode_table_pages = max(self.max_decode_table_pages,
                                              self.pool.max_live_pages())
            self.steps += 1
            self.decode_steps += 1
            self.spec_steps += 1
            self.drafted_tokens += sum(len(b) - 1 for b in blocks)
            host, ok, now = quarantine(batch, logits3, step_idx)
            self.verify_step_s.append(now - t0)
            done = []
            for i, a in enumerate(batch):
                if i not in ok:
                    continue  # quarantined (pages already freed)
                blk, start = blocks[i], a.pos
                # ACCEPTANCE walk: row t predicts position start+t+1; emit
                # its argmax and walk on only while it matches the draft
                # (whose K/V is then already in the pool)
                accepted, fin = 0, False
                for t in range(len(blk)):
                    tok = int(host[i, t].argmax())
                    fed = t + 1 < len(blk) and tok == blk[t + 1]
                    accepted += fed
                    fin = emit(a, host[i, t], now, tok=tok)
                    if fin or not fed:
                        break
                self.accepted_tokens += accepted
                # ROLLBACK: rejected draft tokens, and fed tokens past an
                # in-block EOS or max_new, leave the page table
                new_len = start + 1 + accepted
                if start + len(blk) > new_len:
                    self.pool.truncate_seq(a.seq_id, new_len)
                    self.rolled_back_tokens += start + len(blk) - new_len
                a.pos = new_len
                if fin:
                    done.append(a)
            retire(done, now)

        try:
            while waiting or active:
                newly: List[_Active] = []
                while waiting and len(active) < self.max_batch:
                    req, seq = waiting[0]
                    need = self._footprint(req)
                    if reserved_pages + need > self.pool.num_pages:
                        break  # wait for retirements
                    waiting.pop(0)
                    seq.seq_id = self._next_seq_id
                    self._next_seq_id += 1
                    self.pool.allocate(seq.seq_id)
                    seq.admitted_at = time.perf_counter()
                    a = _Active(req, seq.seq_id, seq, need)
                    active.append(a)
                    newly.append(a)
                    reserved_pages += need
                # the up-front validation guarantees the head request fits
                # an empty pool, so admission always progresses

                if newly:
                    t0 = time.perf_counter()
                    step_idx = self.steps
                    logits = self.model.prefill_step(
                        self.pool, [a.seq_id for a in newly],
                        [a.result.prompt for a in newly])
                    self.steps += 1
                    self.prefill_steps += 1
                    host, ok, now = quarantine(newly, logits, step_idx)
                    self.prefill_step_s.append(now - t0)
                    done = []
                    for i, a in enumerate(newly):
                        a.pos = len(a.result.prompt)
                        if i in ok and emit(a, host[i], now):
                            done.append(a)
                    retire(done, now)
                    continue  # re-admit into freed slots before decoding

                batch = list(active)
                evict_windowed(batch)
                blocks = [self._draft_block(a) for a in batch]
                t0 = time.perf_counter()
                step_idx = self.steps
                if max(len(b) for b in blocks) > 1:
                    verify(batch, blocks, t0, step_idx)
                    continue
                logits = self.model.decode_step(
                    self.pool, [a.seq_id for a in batch],
                    [a.result.tokens[-1] for a in batch],
                    [a.pos for a in batch], **walk_args(batch))
                self.max_decode_table_pages = max(
                    self.max_decode_table_pages, self.pool.max_live_pages())
                self.steps += 1
                self.decode_steps += 1
                host, ok, now = quarantine(batch, logits, step_idx)
                self.decode_step_s.append(now - t0)
                done = []
                for i, a in enumerate(batch):
                    a.pos += 1
                    if i in ok and emit(a, host[i], now):
                        done.append(a)
                retire(done, now)
        except BaseException:
            # ANY raise out of a step or admission: the stepping sequences'
            # pages go back to the pool before the error propagates
            for a in active:
                self.pool.free_seq(a.seq_id)
                self._release_draft(a)
            active.clear()
            raise
        return results
