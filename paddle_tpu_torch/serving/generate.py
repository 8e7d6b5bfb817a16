"""Continuous-batching decode over the paged KV pool, greedy or sampled
per request, with speculative decoding (counterpart of
paddle_tpu/serving/generate.py, its single-device loop).

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
- ``chunk_prefill_step``: a run of prompt tokens per sequence from any
  position (after a cached prefix, or a later chunk of a long prompt);
  its queries attend over the sequence's pages gathered at the pool's
  dtype and computed in fp32, masked by absolute position — plain
  PyTorch, as the JAX package computes it outside any kernel.

Both steps take ``windows`` / ``sinks`` (the sliding-window + attention-
sink decode mask, per row) and ``table_block`` (two-level page tables);
with either, the kernel walks explicit page starts (``_step_tables``).

:class:`ContinuousBatchingLoop` keeps up to ``max_batch`` sequences in
flight.  Admission is reservation-based and FIFO (a request enters only
when the pool covers every admitted sequence's worst case), each
admitted group gets one batched prefill, and each token is the
(bias-shifted) greedy argmax, or for a request with sampling params
(``sampling.SamplingParams``: temperature, top-k, top-p) a draw of the
step's one sampling epilogue, on the logits' device, from JAX's own
(seed, token-index) stream.  A sequence retires on ``eos_id``, its
``max_new`` cap or a stop sequence and returns its pages.  With
``speculate=d`` each decoding sequence drafts up to d tokens by prompt
lookup (``speculative.PromptLookupDrafter``) and one verify step checks
every block: a greedy row commits the longest prefix its argmax agrees
with, a sampled row the outcome of the exact accept/resample epilogue,
and ``pool.truncate_seq`` rolls the rejected tokens back.  A non-finite
logits row quarantines only its own sequence; any exception out of a
step frees every stepping sequence's pages before it propagates.  Both
steps pass an int8 pool's per-page scales to the kernel.  A request
with ``window=`` decodes under the sliding window (plus ``sinks``
tokens' pages); before each decode step the loop evicts
the pages that window can never attend again, so a long context's walk
stays at sinks + window pages.  ``table_block=`` sends every decode and
verify step's tables through the two-level view.  ``prefix_cache=`` (a
``PrefixCache`` over the loop's pool) attaches each admitted prompt's
longest cached prefix and prefills only the rest through chunk steps;
``prefill_chunk=`` caps the prefill tokens of one step, and chunk steps
then alternate with decode steps.

``full_forward`` / ``full_decode`` are the oracles: per-sequence greedy
decode recomputing the whole prefix with plain attention and no cache,
under ``window_mask`` for windowed decode.

Left for later slices: the corpus drafter, the ``prefill="token"`` arm,
adapters, SPMD programs, the tiered KV store and the Engine front end.
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
    gather_kv_pages,
    paged_decode_attention,
    repeat_kv,
)
from ..models.transformer import _sinusoid_table
from . import prefill_sched
from .kvcache import KVCachePool, PagePoolExhausted
from .sampling import (
    SamplingParams,
    apply_bias,
    bias_rows,
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

    @torch.inference_mode()
    def chunk_prefill_step(self, pool: KVCachePool, seq_ids: Sequence[int],
                           chunks: Sequence[Sequence[int]],
                           start_positions: Sequence[int]) -> torch.Tensor:
        """Prefill ``chunks[i]``, consecutive prompt tokens of sequence i,
        from absolute position ``start_positions[i]`` (need not be 0).
        The chunk's K/V lands in the pool through one atomic
        ``append_tokens`` claim (a shared tail page copies there), and its
        queries attend over every page the sequence's table holds — a
        cached prefix, earlier chunks, the chunk itself — gathered at the
        pool's dtype (int8 dequantized) and computed in fp32, as the JAX
        package's einsum of fp32 q with bf16 K promotes: nothing rounds q
        or the weights here.  Key j is visible to the query at position p
        iff j <= p; the rows past each sequence's length are zeroed before
        the products.  A window-evicted table is refused before any slot
        is claimed (the gather places key j at position j).  Returns the
        logits [B, V] at each sequence's last chunk token, meaningful for
        chunks that complete their prompt."""
        cfg = self.cfg
        lens = np.asarray([len(c) for c in chunks], np.int32)
        if not len(lens) or lens.min() < 1:
            raise ValueError("chunk prefill needs non-empty chunks")
        starts = np.asarray(start_positions, np.int64)
        B, Cmax = len(chunks), int(lens.max())
        if int((starts + lens).max()) > cfg.max_length:
            # before append_tokens: a failed chunk must not leave claimed
            # slots with no K/V behind
            raise ValueError(
                f"chunk reaches position {int((starts + lens).max())} > "
                f"max_length {cfg.max_length}")
        for s in seq_ids:
            if pool._tables[s].starts is not None:
                raise ValueError(
                    f"sequence {s} is window-evicted — chunk prefill over a "
                    "compacted page table is unsupported (windows shape "
                    "decode only; prefill before evicting)")
        d, H, Dh = cfg.d_model, cfg.n_head, cfg.head_dim
        Hkv, G = cfg.num_kv_heads, cfg.group_size
        tokens = np.zeros((B, Cmax), np.int64)
        for i, c in enumerate(chunks):
            tokens[i, :lens[i]] = c
        pages, slots = pool.append_tokens(seq_ids, lens)
        tables, total = pool.page_table_batch(seq_ids)
        tables = torch.as_tensor(tables, device=self.device)
        b_idx = self._index(np.repeat(np.arange(B), lens))
        t_idx = self._index(np.concatenate([np.arange(n) for n in lens]))
        S = tables.shape[1] * pool.page_size
        pos = starts[:, None] + np.arange(Cmax)[None, :]  # absolute
        mask = torch.as_tensor(np.arange(S)[None, None, :] <= pos[:, :, None],
                               device=self.device)  # [B, Cmax, S]
        dead = torch.as_tensor(np.arange(S)[None, :] >= total[:, None],
                               device=self.device)[:, None, :, None]
        # padded rows: positions clamped, their values unread
        h = self.embed[self._index(tokens)] * float(np.sqrt(d)) \
            + self.pos[self._index(np.minimum(pos, cfg.max_length - 1))]
        for li, layer in enumerate(self.layers):
            lp = layer.params()
            q = (h @ lp["wq"]).reshape(B, Cmax, H, Dh)
            k = (h @ lp["wk"]).reshape(B, Cmax, Hkv, Dh)
            v = (h @ lp["wv"]).reshape(B, Cmax, Hkv, Dh)
            pool.write_kv(li, pages, slots, k[b_idx, t_idx], v[b_idx, t_idx])
            k_scales, v_scales = pool.layer_scales(li)
            k_full = gather_kv_pages(pool.k_pages[li], tables, k_scales)
            v_full = gather_kv_pages(pool.v_pages[li], tables, v_scales)
            k_full, v_full = repeat_kv(
                k_full.float().masked_fill(dead, 0.0),
                v_full.float().masked_fill(dead, 0.0), G)
            scores = torch.einsum("bihd,bhjd->bhij", q, k_full) * Dh ** -0.5
            w = torch.softmax(scores.masked_fill(~mask[:, None], NEG_INF), -1)
            attn = torch.einsum("bhij,bhjd->bihd", w, v_full).reshape(
                B, Cmax, d)
            h = _layernorm(h + attn @ lp["wo"], lp["ln1_g"], lp["ln1_b"])
            h = _ffn_block(h, lp)
        h_last = h[torch.arange(B, device=self.device), self._index(lens - 1)]
        return h_last @ self.embed.T


@dataclasses.dataclass
class DecodeRequest:
    """One request.  ``window`` (None: full attention) makes its decode
    attend only the pages that overlap the last ``window`` tokens, plus
    the pages of its first ``sinks`` tokens (attention sinks); prefill
    stays full attention.  The loop evicts the pages that mask can never
    light again, and the output is token-identical to ``full_decode``
    under the same ``window_mask``.  ``sampling`` (None: exact greedy)
    carries the request's sampling contract."""

    prompt: Sequence[int]
    max_new_tokens: int
    window: Optional[int] = None
    sinks: int = 0
    sampling: Optional[SamplingParams] = None


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
    __slots__ = ("req", "seq_id", "pos", "result", "charged", "matched",
                 "whole", "inserted")

    def __init__(self, req: DecodeRequest, seq_id: int,
                 result: GeneratedSequence, charged: int, matched: int,
                 whole: bool):
        self.req = req
        self.seq_id = seq_id
        self.pos = matched  # next position to feed
        self.result = result
        self.charged = charged  # pages this admission reserved
        self.matched = matched  # prompt tokens the prefix cache served
        self.whole = whole  # whole-prompt prefill (else chunk steps)
        self.inserted = False  # prompt pages offered to the cache

    def prefilling(self) -> bool:
        """A chunk-mode sequence whose prompt is not all in the pool."""
        return not self.whole and self.pos < len(self.result.prompt)


def _sampled(a: "_Active") -> bool:
    """True when the sequence draws its tokens (temperature > 0)."""
    return a.req.sampling is not None and not a.req.sampling.greedy


class ContinuousBatchingLoop:
    """Admit-as-they-retire decode over one KVCachePool.

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

    Each emitted token is the greedy argmax of its logits row with the
    request's ``logit_bias`` added (on the host, as the JAX package), or,
    for a request whose ``sampling`` has a temperature, one row of the
    step's single ``sample_rows`` call on the logits' device; the g-th
    generated token draws from ``fold_in(PRNGKey(seed), g)``.  A
    sequence retires on EOS, ``min(max_new_tokens, sampling.max_new)`` or
    a stop sequence, checked after every token.  A ``logit_bias`` id
    outside the vocab fails ``run`` before any work.

    ``prefix_cache`` (a :class:`PrefixCache` over this loop's pool)
    matches each admitted prompt's longest cached prefix and attaches its
    pages read-only: the footprint charges only the pages past the
    matched whole pages, and the admission bound also sets aside the
    live attached pages no charge covers (``uncharged_live_pages``).  A
    sequence with a match, or every sequence when ``prefill_chunk`` (0:
    uncapped) is set, prefills through ``chunk_prefill_step``: each chunk
    step packs at most ``prefill_chunk`` prompt tokens FIFO over the
    prefilling sequences (``prefill_flops``: an attention-work budget on
    top, ``prefill_sched.plan_chunks``), and when sequences also decode,
    chunk and decode steps alternate.  A completed prompt's pages go into
    the cache; a retired sequence's pages drop one hold each; a
    quarantined sequence that read cached pages invalidates its chain.

    ``speculate=d`` (0: off) arms speculative decoding: each
    decoding sequence drafts up to min(d, its remaining max_new) tokens
    with ``drafter`` (None: a ``PromptLookupDrafter(max_draft=d)``; a
    drafter with ``stateful`` set gets ``seq_id=`` and a ``release`` on
    retirement and quarantine); when any block is longer than one token
    the step is a ``verify_step``.  A greedy sequence commits the longest
    prefix of its draft that the model's (biased) argmax agrees with,
    plus the model's own next token; the drafted sampled sequences go
    through one ``spec_sample_rows`` call (accept with probability p(d),
    else resample the residual), and an undrafted sampled one takes the
    plain epilogue.  EOS, the cap and stop sequences retire a sequence
    inside its block; the rejected tokens leave the pool through
    ``truncate_seq`` and consume no token index.  Greedy output is
    token-identical to unspeculated decode, sampled output
    distribution-identical.

    Requests with ``window=`` decode under the window + sink mask: a
    step whose batch holds a generating windowed sequence passes per-row
    windows and sinks (PAD_START / 0 for the others), and before each
    decode step every generating windowed sequence's dead interior pages
    are evicted.  ``table_block=b`` (None: flat tables) walks every
    decode and verify step's tables through the two-level view with L2
    blocks of b pages.

    Counters: ``steps``, ``prefill_steps`` (chunk steps included),
    ``decode_steps`` (verify steps included), ``spec_steps`` (verify
    steps), ``drafted_tokens``, ``accepted_tokens``,
    ``rolled_back_tokens``, ``quarantined``, ``pages_evicted``,
    ``max_decode_table_pages`` (the widest table any decode or verify
    step walked, after its eviction and appends), ``prefix_hits``,
    ``prefix_misses``, ``cached_prefill_tokens``, ``prefill_tokens`` (the
    prompt tokens the model ran), ``max_prefill_tokens_step``; host-clock
    durations of each step (ending after the logits reach the host) in
    ``prefill_step_s`` (chunk steps included), ``decode_step_s`` and
    ``verify_step_s``, and of each sampling epilogue call (``sample_rows``
    or ``spec_sample_rows``, bias and host copy included, after the
    step's end) in ``epilogue_s``."""

    def __init__(self, params: Union[Dict, TransformerDecoder],
                 cfg: DecodeConfig, pool: KVCachePool, max_batch: int = 4,
                 device=None, speculate: int = 0, drafter=None,
                 table_block: Optional[int] = None, prefix_cache=None,
                 prefill_chunk: int = 0,
                 prefill_flops: Optional[float] = None):
        if int(speculate) < 0:
            raise ValueError("speculate must be >= 0")
        if table_block is not None and int(table_block) < 1:
            raise ValueError("table_block must be >= 1 (or None)")
        if prefix_cache is not None and prefix_cache.pool is not pool:
            raise ValueError(
                "prefix_cache is wired to a different pool — shared pages "
                "and refcounts must live in the pool this loop appends to")
        if int(prefill_chunk) < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if prefill_flops is not None and prefill_flops <= 0:
            raise ValueError("prefill_flops must be > 0 (or None)")
        if prefill_flops is not None and not prefill_chunk:
            raise ValueError(
                "prefill_flops needs chunked prefill — also pass a nonzero "
                "prefill_chunk (it still clamps tokens; the flop budget "
                "binds where it is tighter)")
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
        self.prefix_cache = prefix_cache
        self._prefill_chunk = int(prefill_chunk)
        self._prefill_flops = (float(prefill_flops)
                               if prefill_flops is not None else None)
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
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.cached_prefill_tokens = 0
        self.prefill_tokens = 0
        self.max_prefill_tokens_step = 0
        self._prefer_prefill = True
        self.prefill_step_s: List[float] = []
        self.decode_step_s: List[float] = []
        self.verify_step_s: List[float] = []
        self.epilogue_s: List[float] = []

    def acceptance_rate(self) -> float:
        """Accepted / drafted tokens (0.0 before any draft)."""
        return (self.accepted_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    @staticmethod
    def _max_new(a: "_Active") -> int:
        """The effective cap: max_new_tokens, tightened by the sampling
        params' max_new."""
        p = a.req.sampling
        if p is not None and p.max_new is not None:
            return min(a.req.max_new_tokens, p.max_new)
        return a.req.max_new_tokens

    def _spec_room(self, a: "_Active") -> int:
        """Draft tokens sequence `a` may carry this step: the loop's d,
        capped by its remaining max_new headroom — so the fed block never
        passes the worst case its admission reserved."""
        if not self._speculate:
            return 0
        return min(self._speculate, self._max_new(a) - len(a.result.tokens))

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

    def _footprint(self, req: DecodeRequest, matched: int = 0) -> int:
        """Worst-case pages a request pulls from the free list.  With
        ``matched`` prompt tokens served by the prefix cache, only the
        pages past the matched whole pages are charged (the copy-on-write
        of a shared partial tail page among them): the whole pages attach
        without free-list pressure."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.cfg.max_length:
            raise ValueError(f"prompt+max_new={total} exceeds max_length "
                             f"{self.cfg.max_length}")
        ps = self.pool.page_size
        return KVCachePool.pages_needed(total - matched // ps * ps, ps)

    def _cache_insert(self, a: _Active) -> None:
        """Offer a fully prefilled prompt's pages to the prefix cache,
        once per sequence."""
        if self.prefix_cache is None or a.inserted:
            return
        a.inserted = True
        self.prefix_cache.insert(a.seq_id, a.result.prompt)

    def _note_prefill(self, ntok: int) -> None:
        self.prefill_tokens += ntok
        self.max_prefill_tokens_step = max(self.max_prefill_tokens_step, ntok)

    def run(self, requests: Sequence[DecodeRequest]
            ) -> List[GeneratedSequence]:
        waiting: List[Tuple[DecodeRequest, GeneratedSequence]] = []
        results: List[GeneratedSequence] = []
        for req in requests:
            if not len(req.prompt):
                raise ValueError("empty prompt")
            if req.sampling is not None \
                    and req.sampling.max_bias_token() >= self.cfg.vocab_size:
                raise ValueError(
                    f"logit_bias token {req.sampling.max_bias_token()} >= "
                    f"vocab_size {self.cfg.vocab_size}")
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
        cache = self.prefix_cache

        def quarantine(batch: List[_Active], logits: torch.Tensor,
                       step_idx: int) -> Tuple[np.ndarray, set, float]:
            """One host copy of the step's logits; every non-finite row's
            sequence is scrubbed, freed and failed, and its cached chain
            quarantined (prefill_sched.evict_nonfinite).  Returns (host
            logits, surviving row indices, post-sync step-end time)."""

            def on_evict(i: int, now: float) -> None:
                nonlocal reserved_pages
                a = batch[i]
                self._release_draft(a)
                active.remove(a)
                a.result.error = NonFiniteSequenceError(a.seq_id, step_idx)
                a.result.finished_at = now
                reserved_pages -= a.charged
                self.quarantined += 1

            host, finite, now = prefill_sched.evict_nonfinite(
                self.pool, cache, [a.seq_id for a in batch],
                [a.matched for a in batch], logits, on_evict)
            return host, set(np.flatnonzero(finite).tolist()), now

        def emit(a: _Active, row: np.ndarray, now: float,
                 tok: Optional[int] = None) -> bool:
            """Record one token (None: the argmax of ``row`` with the
            request's bias added); True when the sequence is done — EOS,
            its cap or a stop sequence, checked after every token, so one
            inside an accepted draft block retires it there."""
            params = a.req.sampling
            if tok is None:
                tok = int(apply_bias(row, params).argmax())
            a.result.tokens.append(tok)
            a.result.logits.append(row)
            if a.result.ttft_s is None:
                a.result.ttft_s = now - a.result.admitted_at
            return (len(a.result.tokens) >= self._max_new(a)
                    or (self.cfg.eos_id is not None
                        and tok == self.cfg.eos_id)
                    or stop_hit(a.result.tokens, params))

        def emit_batch(pairs: List[Tuple[_Active, np.ndarray, int]],
                       dev: torch.Tensor, now: float) -> List[_Active]:
            """Emit one token for each (sequence, host row, row index of
            ``dev``): the sampled rows through ONE ``sample_rows`` call on
            ``dev``'s device (bias added there), the greedy rows by host
            argmax.  Returns the finished sequences."""
            toks: List[Optional[int]] = [None] * len(pairs)
            sampled = [j for j, (a, _, _) in enumerate(pairs) if _sampled(a)]
            if sampled:
                t0 = time.perf_counter()
                params = [pairs[j][0].req.sampling for j in sampled]
                idx = torch.as_tensor([pairs[j][2] for j in sampled],
                                      device=dev.device)
                chosen = sample_rows(
                    bias_rows(dev.index_select(0, idx), params), params,
                    [len(pairs[j][0].result.tokens) for j in sampled])
                self.epilogue_s.append(time.perf_counter() - t0)
                for j, tk in zip(sampled, chosen):
                    toks[j] = int(tk)
            return [a for (a, row, _), tk in zip(pairs, toks)
                    if emit(a, row, now, tok=tk)]

        def retire(done: List[_Active], now: float) -> None:
            nonlocal reserved_pages
            for a in done:
                active.remove(a)
                a.result.finished_at = now
                self.pool.free_seq(a.seq_id)
                if cache is not None:
                    cache.forget_seq(a.seq_id)
                self._release_draft(a)
                reserved_pages -= a.charged

        def admit() -> List[_Active]:
            """FIFO admission while a slot and the worst-case reservation
            fit; a prefix-cache match is attached and charged only its
            unshared pages, and the live attached pages no charge covers
            are set aside."""
            nonlocal reserved_pages
            newly: List[_Active] = []
            while waiting and len(active) < self.max_batch:
                req, seq = waiting[0]
                m = cache.match(req.prompt) if cache is not None else None
                need = self._footprint(req, m.tokens if m else 0)
                locked = (self.pool.uncharged_live_pages()
                          if cache is not None else 0)
                if reserved_pages + need > self.pool.num_pages - locked:
                    break  # wait for retirements
                waiting.pop(0)
                seq.seq_id = self._next_seq_id
                self._next_seq_id += 1
                self.pool.allocate(seq.seq_id)
                matched = 0
                if m is not None:
                    matched = cache.attach(seq.seq_id, m)
                    if matched:
                        self.prefix_hits += 1
                        self.cached_prefill_tokens += matched
                    else:
                        self.prefix_misses += 1
                seq.admitted_at = time.perf_counter()
                a = _Active(req, seq.seq_id, seq, need, matched,
                            prefill_sched.whole_eligible(
                                matched, self._prefill_chunk))
                active.append(a)
                newly.append(a)
                reserved_pages += need
            # the up-front validation guarantees the head request fits an
            # empty pool, so admission always progresses
            return newly

        def whole_prefill(group: List[_Active]) -> None:
            """ONE whole-prompt prefill step for a co-admitted group."""
            t0 = time.perf_counter()
            step_idx = self.steps
            logits = self.model.prefill_step(
                self.pool, [a.seq_id for a in group],
                [a.result.prompt for a in group])
            self.steps += 1
            self.prefill_steps += 1
            self._note_prefill(sum(len(a.result.prompt) for a in group))
            host, ok, now = quarantine(group, logits, step_idx)
            self.prefill_step_s.append(now - t0)
            pairs = []
            for i, a in enumerate(group):
                a.pos = len(a.result.prompt)
                if i not in ok:
                    continue
                self._cache_insert(a)
                pairs.append((a, host[i], i))
            retire(emit_batch(pairs, logits, now), now)

        def chunk_prefill(chunkers: List[_Active]) -> None:
            """One chunk step over the prefilling sequences, packed by
            prefill_sched.plan_chunks; a sequence whose chunk completes
            its prompt is inserted into the cache and emits its first
            token."""
            t0 = time.perf_counter()
            step_idx = self.steps
            idx, chunks, starts = prefill_sched.plan_chunks(
                [a.result.prompt for a in chunkers],
                [a.pos for a in chunkers], self._prefill_chunk,
                flop_budget=self._prefill_flops)
            sel = [chunkers[i] for i in idx]
            logits = self.model.chunk_prefill_step(
                self.pool, [a.seq_id for a in sel], chunks, starts)
            self.steps += 1
            self.prefill_steps += 1
            self._note_prefill(sum(len(c) for c in chunks))
            host, ok, now = quarantine(sel, logits, step_idx)
            self.prefill_step_s.append(now - t0)
            pairs = []
            for i, a in enumerate(sel):
                if i not in ok:
                    continue
                a.pos += len(chunks[i])
                if a.pos >= len(a.result.prompt):
                    self._cache_insert(a)
                    pairs.append((a, host[i], i))
            retire(emit_batch(pairs, logits, now), now)

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

        def settle(a: _Active, blk: List[int], accepted: int) -> None:
            """ROLLBACK after a sequence's walk: rejected draft tokens, and
            fed tokens past an in-block EOS, stop or cap, leave the page
            table."""
            self.accepted_tokens += accepted
            new_len = a.pos + 1 + accepted
            if a.pos + len(blk) > new_len:
                self.pool.truncate_seq(a.seq_id, new_len)
                self.rolled_back_tokens += a.pos + len(blk) - new_len
            a.pos = new_len

        def verify(batch: List[_Active], blocks: List[List[int]],
                   t0: float, step_idx: int) -> None:
            """One verify step over every sequence's block, then each
            sequence's walk and rollback: the longest-prefix walk for a
            greedy sequence, one accept/resample epilogue call for the
            drafted sampled ones, the plain epilogue for an undrafted
            sampled one."""
            logits3 = self.model.verify_step(
                self.pool, [a.seq_id for a in batch], blocks,
                [a.pos for a in batch], pad_to=self._speculate + 1,
                **walk_args(batch))
            self.max_decode_table_pages = max(
                self.max_decode_table_pages,
                self.pool.max_live_pages([a.seq_id for a in batch]))
            self.steps += 1
            self.decode_steps += 1
            self.spec_steps += 1
            self.drafted_tokens += sum(len(b) - 1 for b in blocks)
            host, ok, now = quarantine(batch, logits3, step_idx)
            self.verify_step_s.append(now - t0)
            done: List[_Active] = []
            pairs = []  # undrafted sampled rows: the plain epilogue
            spec: List[Tuple[int, _Active]] = []  # drafted sampled rows
            for i, a in enumerate(batch):
                if i not in ok:
                    continue  # quarantined (pages already freed)
                blk = blocks[i]
                if _sampled(a):
                    if len(blk) == 1:
                        a.pos += 1
                        pairs.append((a, host[i, 0], i))
                    else:
                        spec.append((i, a))
                    continue
                # ACCEPTANCE walk: row t predicts position pos+t+1; emit
                # its biased argmax and walk on only while it matches the
                # draft (whose K/V is then already in the pool)
                accepted, fin = 0, False
                for t in range(len(blk)):
                    tok = int(apply_bias(host[i, t], a.req.sampling).argmax())
                    fed = t + 1 < len(blk) and tok == blk[t + 1]
                    accepted += fed
                    fin = emit(a, host[i, t], now, tok=tok)
                    if fin or not fed:
                        break
                settle(a, blk, accepted)
                if fin:
                    done.append(a)
            if spec:
                # one accept/resample call on the logits' device decides
                # every drafted sampled row; the host walk then emits and
                # rolls back as the greedy walk does
                t1 = time.perf_counter()
                params = [a.req.sampling for _, a in spec]
                idx = torch.as_tensor([i for i, _ in spec],
                                      device=logits3.device)
                acc, toks = spec_sample_rows(
                    bias_rows(logits3.index_select(0, idx), params), params,
                    [len(a.result.tokens) for _, a in spec],
                    [blocks[i][1:] for i, _ in spec])
                self.epilogue_s.append(time.perf_counter() - t1)
                for r, (i, a) in enumerate(spec):
                    accepted, fin = 0, False
                    for t in range(int(acc[r]) + 1):
                        fed = t < int(acc[r])
                        accepted += fed
                        fin = emit(a, host[i, t], now, tok=int(toks[r, t]))
                        if fin or not fed:
                            break
                    settle(a, blocks[i], accepted)
                    if fin:
                        done.append(a)
            done += emit_batch(pairs, logits3[:, 0], now)
            retire(done, now)

        try:
            while waiting or active:
                whole = [a for a in admit() if a.whole]
                if whole:
                    whole_prefill(whole)
                    continue  # re-admit into freed slots before decoding
                chunkers = [a for a in active if a.prefilling()]
                decodable = [a for a in active if not a.prefilling()]
                if chunkers and (not decodable or self._prefer_prefill):
                    # chunk and decode steps alternate while both have work
                    chunk_prefill(chunkers)
                    self._prefer_prefill = False
                    continue
                if not decodable:
                    continue
                self._prefer_prefill = True
                batch = decodable
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
                    self.max_decode_table_pages,
                    self.pool.max_live_pages([a.seq_id for a in batch]))
                self.steps += 1
                self.decode_steps += 1
                host, ok, now = quarantine(batch, logits, step_idx)
                self.decode_step_s.append(now - t0)
                pairs = []
                for i, a in enumerate(batch):
                    a.pos += 1
                    if i in ok:
                        pairs.append((a, host[i], i))
                retire(emit_batch(pairs, logits, now), now)
        except BaseException:
            # ANY raise out of a step or admission: the stepping sequences'
            # pages go back to the pool before the error propagates
            for a in active:
                self.pool.free_seq(a.seq_id)
                if cache is not None:
                    cache.forget_seq(a.seq_id)
                self._release_draft(a)
            active.clear()
            raise
        return results
