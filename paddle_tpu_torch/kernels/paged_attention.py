"""Decode and verify attention over a paged KV pool (counterpart of
paddle_tpu/kernels/paged_attention.py).

``paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
scale, q_lengths=None, k_scales=None, v_scales=None)``: Sq query tokens
per sequence (q [B, H_q, Sq, D]) against that sequence's cached keys and
values, which live in pages of one layer of the pool (k_pages/v_pages
[H_kv, P, page_size, D]).  ``page_tables`` is the flat [B, max_pages]
int32 table, zero-padded past each sequence's pages (the padded entries
point at page 0 and are masked by position); ``lengths`` [B] holds the
valid token counts, the fed tokens included.  H_q must be a multiple of
H_kv (GQA): query head h reads KV head h // (H_q / H_kv), and anything
else raises :class:`GroupedHeadsError`.

- Sq = 1 is plain decode: the query is the last valid position.
- Sq > 1 is the speculative verify step: ``q_lengths`` [B] (None: all
  Sq) gives each sequence's valid query rows, and query row t of
  sequence b sits at position ``lengths[b] - q_lengths[b] + t``; key j
  is visible to it iff ``j <= lengths[b] - q_lengths[b] + t`` and
  ``j < lengths[b]``.  Rows t >= q_lengths[b] hold values nobody reads.
- An int8 pool passes its layer's per-page fp32 ``k_scales`` /
  ``v_scales`` [P] (together); K and V dequantize as int8 * scale of
  their own page.  An int8 pool without scales raises.

Four kernel variants, one CUDA kernel (``csrc/paged_decode.cu``):
``decode_f32``, ``verify_f32``, ``decode_i8`` and ``verify_i8``, each
over one of three table walks (below).

- On a CUDA tensor it launches the variant or raises.  There is no
  envelope and no fallback: a geometry the kernel does not take is an
  error, not a silent switch to the gather.
- On a CPU tensor it computes the plain version:
  :func:`paged_decode_reference` for Sq = 1 (gather, ``repeat_kv``,
  reference attention with ``k_lengths``) and
  :func:`paged_verify_reference` for Sq > 1 (a dense masked softmax over
  the gathered view, the JAX ``_reference_verify``); an int8 pool
  dequantizes in the gather.

Long-context surfaces (the JAX package's window + sink decode):

- ``page_starts`` [B, max_pages] int32 (:data:`PAD_START` past a row's
  pages) gives the absolute position of each table entry's slot 0.  An
  evicted sequence's table is compacted, so slot ``s`` of its table sits
  at ``page_starts[b, s // page_size] + s % page_size``, not at ``s``.
- ``page_tables`` may be a :class:`TwoLevelTables` (an L1 directory over
  L2 blocks of page ids and starts); it carries its own starts, and
  ``page_starts`` beside it raises.
- ``windows`` / ``sinks`` [B] int32 (sinks needs windows) add the
  page-granular visibility rule: key page start ``st`` is visible to the
  query at position ``qp`` iff ``st < sinks[b]`` or ``st + page_size >
  qp + 1 - windows[b]``.  A row with no window passes ``windows[b] =
  PAD_START``.

With any of these the kernel walks table slots with explicit starts
(``csrc/paged_decode.cu``, the ``starts`` and ``two_level`` walks; the
plain version is :func:`paged_windowed_reference`).

``paged_decode_attention.launches`` counts kernel launches;
``launches_by_variant`` splits them by variant (Sq and pool dtype),
``launches_by_table`` by walk (``flat``, ``starts``, ``two_level``), and
``windowed_launches`` counts the launches that carried windows.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from . import _build
from .flash_attention import NEG_INF, reference_attention

__all__ = ["GroupedHeadsError", "PAD_START", "TABLE_WALKS", "TwoLevelTables",
           "VARIANTS", "gather_kv_pages", "paged_decode_attention",
           "paged_decode_reference", "paged_verify_reference",
           "paged_windowed_reference", "repeat_kv", "reset_launches"]

VARIANTS = ("decode_f32", "verify_f32", "decode_i8", "verify_i8")
TABLE_WALKS = ("flat", "starts", "two_level")
# the start of a padding slot in an explicit-starts operand (a flat
# page_starts row past the sequence's pages, or a two-level pad block):
# far past any length, so the position mask hides the page-0 read behind
# it.  PAD_START + page_size and qp + 1 - PAD_START both fit in int32.
PAD_START = 0x3FFFFFFF
_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535


class GroupedHeadsError(ValueError):
    """H_q is not a multiple of H_kv: no query-head group maps cleanly
    onto a KV head.  A config error, raised typed."""


@dataclasses.dataclass(frozen=True)
class TwoLevelTables:
    """Two-level page-table view of a batch (the JAX ``TwoLevelTables``):

    - ``l1`` [B, n_l1] int32: entry j of row b names the L2 block that
      holds that sequence's table entries [j * bs, (j + 1) * bs);
    - ``l2`` [n_blocks, bs] int32: page ids (page 0 in padding slots);
    - ``starts`` [n_blocks, bs] int32: the absolute position of each
      page's slot 0 (:data:`PAD_START` in padding slots);
    - ``block_size``: bs.

    Page entry p of sequence b is ``l2[l1[b, p // bs], p % bs]``.  The
    arrays may be numpy arrays or tensors; ``KVCachePool.two_level_tables``
    builds them on the host."""

    l1: object
    l2: object
    starts: object
    block_size: int

    @property
    def max_pages(self) -> int:
        return self.l1.shape[1] * self.block_size

    def flatten(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(tables [B, max_pages], starts [B, max_pages]) int32 tensors:
        the flat view the plain version gathers through."""
        l1 = torch.as_tensor(self.l1).to(torch.long)
        l2 = torch.as_tensor(self.l2, device=l1.device).to(torch.int32)
        st = torch.as_tensor(self.starts, device=l1.device).to(torch.int32)
        b, n_l1 = l1.shape
        return (l2[l1].reshape(b, n_l1 * self.block_size),
                st[l1].reshape(b, n_l1 * self.block_size))


def _group_size(num_q_heads: int, num_kv_heads: int) -> int:
    """Query heads per KV head, or GroupedHeadsError — the one
    divisibility check every GQA entry point (kernel, pool, config)
    goes through."""
    if num_kv_heads < 1 or num_q_heads % num_kv_heads:
        raise GroupedHeadsError(
            f"{num_q_heads} query heads do not group over {num_kv_heads} "
            "KV heads — H_q must be a positive multiple of H_kv")
    return num_q_heads // num_kv_heads


def repeat_kv(k, v, group: int):
    """[.., H_kv, ..] -> [.., H_q, ..] on dim 1, query head h reading KV
    head h // group (``repeat_interleave`` keeps each group's heads
    adjacent, as ``jnp.repeat`` does).  No-op for group 1."""
    if group == 1:
        return k, v
    return (torch.repeat_interleave(k, group, dim=1),
            torch.repeat_interleave(v, group, dim=1))


def gather_kv_pages(pages, page_tables, scales=None) -> torch.Tensor:
    """pages [H_kv, P, page_size, D] (one layer of the pool) + page_tables
    [B, max_pages] -> contiguous [B, H_kv, max_pages * page_size, D].
    With ``scales`` (the layer's [P] per-page fp32 scales of an int8
    pool) the gathered content dequantizes to fp32, each page's rows
    times its own scale.  Rows past a sequence's length hold whatever
    the padding pages hold: callers mask them."""
    tables = torch.as_tensor(page_tables, device=pages.device).to(torch.long)
    b, n_pages = tables.shape
    flat = tables.reshape(-1)
    g = pages.index_select(1, flat)  # [H, B*maxp, ps, D]
    if scales is not None:
        s = torch.as_tensor(scales, device=pages.device).to(torch.float32)
        g = g.to(torch.float32) * s.index_select(0, flat)[None, :, None,
                                                          None]
    h, _, ps, d = g.shape
    return g.reshape(h, b, n_pages * ps, d).permute(1, 0, 2, 3).contiguous()


def _gathered(k_pages, v_pages, page_tables, lengths, k_scales, v_scales):
    """Gathered (and dequantized) K and V [B, H_kv, S, D], with the rows
    past each length zeroed: padded table entries read page 0, and
    another sequence's non-finite content there must not reach this one
    through 0 * NaN (the kernel never loads those rows)."""
    k = gather_kv_pages(k_pages, page_tables, k_scales)
    v = gather_kv_pages(v_pages, page_tables, v_scales)
    ln = torch.as_tensor(lengths, device=k.device).to(torch.long).reshape(-1)
    dead = (torch.arange(k.shape[2], device=k.device)[None, :]
            >= ln[:, None])[:, None, :, None]
    return k.masked_fill(dead, 0.0), v.masked_fill(dead, 0.0), ln


def paged_decode_reference(q, k_pages, v_pages, page_tables, lengths,
                           scale=None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Plain version of the Sq = 1 variants: gather (dequantizing an int8
    pool), repeat_kv, reference attention over the valid ``lengths``
    keys.  q [B, H_q, 1, D] -> [B, H_q, 1, D]."""
    G = _group_size(q.shape[1], k_pages.shape[0])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k, v, ln = _gathered(k_pages, v_pages, page_tables, lengths, k_scales,
                         v_scales)
    k, v = repeat_kv(k, v, G)
    return reference_attention(q, k, v, causal=False, scale=scale,
                               k_lengths=ln)


def paged_verify_reference(q, k_pages, v_pages, page_tables, lengths,
                           q_lengths=None, scale=None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Plain version of the Sq > 1 variants (JAX ``_reference_verify``):
    dense attention over the gathered view with the per-row causal
    frontier — key j visible to row t of sequence b iff ``j <=
    lengths[b] - q_lengths[b] + t`` and ``j < lengths[b]``.  A row with
    no visible key returns zeros, as the kernel does.  q [B, H_q, Sq, D]
    -> [B, H_q, Sq, D]."""
    B, Hq, Sq, D = q.shape
    G = _group_size(Hq, k_pages.shape[0])
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k, v, ln = _gathered(k_pages, v_pages, page_tables, lengths, k_scales,
                         v_scales)
    k, v = repeat_kv(k, v, G)
    ql = (torch.full((B,), Sq, device=q.device) if q_lengths is None
          else torch.as_tensor(q_lengths, device=q.device).reshape(-1))
    pos_q = (ln - ql.to(torch.long))[:, None] + torch.arange(
        Sq, device=q.device)[None, :]  # [B, Sq]
    j = torch.arange(k.shape[2], device=q.device)
    vis = (j[None, None, :] <= pos_q[:, :, None]) \
        & (j[None, None, :] < ln[:, None, None])  # [B, Sq, S]
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    scores = scores.masked_fill(~vis[:, None], NEG_INF)
    weights = torch.softmax(scores, dim=-1).masked_fill(
        ~vis.any(-1)[:, None, :, None], 0.0)
    return torch.matmul(weights, v)


def paged_windowed_reference(q, k_pages, v_pages, page_tables, lengths,
                             q_lengths=None, page_starts=None, windows=None,
                             sinks=None, scale=None, k_scales=None,
                             v_scales=None) -> torch.Tensor:
    """Plain version of the explicit-starts, windowed and two-level walks
    (JAX ``_reference_windowed``): a dense masked softmax over the
    gathered view.  ``page_tables`` is flat [B, max_pages] or a
    :class:`TwoLevelTables` (flattened first); key positions come from
    the per-page starts (None: ``p * page_size``).  Key j of page start
    ``st_j`` and position ``pos_j`` is visible to query row t (position
    ``qp_t = lengths[b] - q_lengths[b] + t``) iff ``pos_j <= qp_t``,
    ``pos_j < lengths[b]`` and (``st_j < sinks[b]`` or ``st_j + page_size
    > qp_t + 1 - windows[b]``); no windows means no window term.  Keys at
    ``pos >= lengths[b]`` and in ``PAD_START`` slots are zeroed before the
    product, so that 0 * NaN from a padding page never leaks, and a row
    that sees no key returns zeros, as the kernel does.  q [B, H_q, Sq,
    D] -> [B, H_q, Sq, D]."""
    B, Hq, Sq, D = q.shape
    G = _group_size(Hq, k_pages.shape[0])
    ps = k_pages.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    if isinstance(page_tables, TwoLevelTables):
        if page_starts is not None:
            raise ValueError("a TwoLevelTables walk carries its own starts")
        page_tables, page_starts = page_tables.flatten()
    tables = torch.as_tensor(page_tables, device=dev).to(torch.long)
    n_pages = tables.shape[1]
    st = (torch.arange(n_pages, device=dev)[None, :].expand(B, n_pages)
          * ps if page_starts is None
          else torch.as_tensor(page_starts, device=dev).to(torch.long))
    ln = torch.as_tensor(lengths, device=dev).to(torch.long).reshape(-1)
    ql = (torch.full((B,), Sq, device=dev) if q_lengths is None
          else torch.as_tensor(q_lengths, device=dev).to(torch.long)
          .reshape(-1))
    pstart = st.repeat_interleave(ps, dim=1)  # [B, S]
    kpos = pstart + torch.arange(ps, device=dev).repeat(n_pages)[None, :]
    dead = ((kpos >= ln[:, None]) | (pstart == PAD_START))[:, None, :, None]
    k = gather_kv_pages(k_pages, tables, k_scales).masked_fill(dead, 0.0)
    v = gather_kv_pages(v_pages, tables, v_scales).masked_fill(dead, 0.0)
    k, v = repeat_kv(k, v, G)
    qpos = (ln - ql)[:, None] + torch.arange(Sq, device=dev)[None, :]
    kp, sp, qp = kpos[:, None, :], pstart[:, None, :], qpos[:, :, None]
    vis = (kp <= qp) & (kp < ln[:, None, None])  # [B, Sq, S]
    if windows is not None:
        win = torch.as_tensor(windows, device=dev).to(torch.long).reshape(-1)
        snk = (torch.zeros_like(win) if sinks is None
               else torch.as_tensor(sinks, device=dev).to(torch.long)
               .reshape(-1))
        vis = vis & ((sp < snk[:, None, None])
                     | (sp + ps > qp + 1 - win[:, None, None]))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    scores = scores.masked_fill(~vis[:, None], NEG_INF)
    weights = torch.softmax(scores, dim=-1).masked_fill(
        ~vis.any(-1)[:, None, :, None], 0.0)
    return torch.matmul(weights, v)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.library("paged_decode"), "paged_" + name)
    if name == "decode_f32":
        # q, k, v, tables, lengths, o; B, H_kv, G, P, page_size,
        # max_pages, D; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
    elif name.startswith("walk"):
        # q, k, v, k_scales, v_scales, tables, l2, starts, lengths,
        # q_lengths, windows, sinks, o; B, H_kv, G, Sq, P, page_size,
        # max_pages, block_size, n_blocks, D; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
    else:
        # q, k, v, k_scales, v_scales, tables, lengths, q_lengths, o;
        # B, H_kv, G, Sq, P, page_size, max_pages, D; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, tables, lengths, q_lengths, k_scales,
           v_scales) -> None:
    kv_dtype = k_pages.dtype
    if kv_dtype not in (torch.float32, torch.int8):
        raise TypeError(f"paged_decode takes a float32 or int8 pool, got "
                        f"{kv_dtype}")
    named = [("q", q, torch.float32), ("k_pages", k_pages, kv_dtype),
             ("v_pages", v_pages, kv_dtype)]
    if k_scales is not None:
        named += [("k_scales", k_scales, torch.float32),
                  ("v_scales", v_scales, torch.float32)]
    for name, t, dtype in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"paged_decode: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16 bytes a thread)")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pools must be matching [H_kv, P, page_size, D], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    B, _, _, D = q.shape
    if k_pages.shape[3] != D:
        raise ValueError(f"pool head_dim {k_pages.shape[3]} != query {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode supports head_dim {_HEAD_DIMS}, got {D}")
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {_MAX_GRID_Y}")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"tables must be [B={B}, max_pages] and lengths [B], got "
            f"{tuple(tables.shape)} and {tuple(lengths.shape)}")
    if q_lengths is not None and q_lengths.shape != (B,):
        raise ValueError(f"q_lengths must be [B={B}], got "
                         f"{tuple(q_lengths.shape)}")
    if k_scales is not None and (k_scales.shape != (k_pages.shape[1],)
                                 or v_scales.shape != k_scales.shape):
        raise ValueError(f"scales must be [P={k_pages.shape[1]}], got "
                         f"{tuple(k_scales.shape)} and "
                         f"{tuple(v_scales.shape)}")


def _int32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def _walk_operands(page_tables, page_starts, windows, sinks, B, page_size,
                   device):
    """The explicit-starts walk's int32 operands on the card: (tables or
    L1 [B, n], L2 [n_blocks, bs] or None, starts [B, max_pages] or
    [n_blocks, bs], block_size (0: flat), windows [B] or None, sinks [B]
    or None).  A flat table with windows but no starts gets its implicit
    starts ``p * page_size``, so the walk is the same one."""
    if isinstance(page_tables, TwoLevelTables):
        bs = int(page_tables.block_size)
        tables = _int32(page_tables.l1, device)
        l2 = _int32(page_tables.l2, device)
        starts = _int32(page_tables.starts, device)
        if bs < 1 or l2.dim() != 2 or l2.shape[1] != bs \
                or starts.shape != l2.shape or l2.shape[0] < 1:
            raise ValueError(
                f"two-level tables need l2 and starts [n_blocks >= 1, "
                f"bs={bs}], got {tuple(l2.shape)} and {tuple(starts.shape)}")
    else:
        bs, l2 = 0, None
        tables = _int32(page_tables, device)
        starts = (_int32(page_starts, device) if page_starts is not None
                  else (torch.arange(tables.shape[1], dtype=torch.int32,
                                     device=device) * page_size)
                  .expand(tables.shape).contiguous())
        if starts.shape != tables.shape:
            raise ValueError(f"page_starts must be shaped like the table "
                             f"{tuple(tables.shape)}, got "
                             f"{tuple(starts.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B={B}, n], got "
                         f"{tuple(tables.shape)}")
    win = snk = None
    if windows is not None:
        win = _int32(windows, device).reshape(-1)
        snk = (torch.zeros(B, dtype=torch.int32, device=device)
               if sinks is None else _int32(sinks, device).reshape(-1))
        if win.shape != (B,) or snk.shape != (B,):
            raise ValueError(f"windows and sinks must be [B={B}], got "
                             f"{tuple(win.shape)} and {tuple(snk.shape)}")
    return tables, l2, starts, bs, win, snk


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
                           scale=None, q_lengths=None, k_scales=None,
                           v_scales=None, page_starts=None, windows=None,
                           sinks=None) -> torch.Tensor:
    """q [B, H_q, Sq, D] fp32; k_pages/v_pages [H_kv, P, page_size, D]
    fp32 or int8; page_tables [B, max_pages] int32 or a
    :class:`TwoLevelTables`; lengths [B] (the fed tokens already
    appended); q_lengths [B] (Sq > 1 only); k_scales / v_scales [P] fp32
    (int8 pools only); page_starts [B, max_pages] (flat tables only),
    windows / sinks [B] int32.  Returns [B, H_q, Sq, D] fp32."""
    if q.dim() != 4:
        raise ValueError(f"decode query must be [B, H, Sq, D], got "
                         f"{tuple(q.shape)}")
    Sq = q.shape[2]
    if Sq < 1:
        raise ValueError(f"decode query must carry >= 1 token, got "
                         f"{tuple(q.shape)}")
    if Sq == 1 and q_lengths is not None:
        raise ValueError(
            "q_lengths is the multi-token verify contract — a single-"
            "token decode step has nothing ragged to mask")
    G = _group_size(q.shape[1], k_pages.shape[0])
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be passed together")
    quantized = k_pages.dtype == torch.int8
    if quantized and k_scales is None:
        raise ValueError(
            "an int8 KV pool needs its per-page k_scales/v_scales — "
            "raw int8 content is meaningless without them")
    if k_scales is not None and not quantized:
        raise ValueError("k_scales/v_scales dequantize an int8 pool; this "
                         f"pool is {k_pages.dtype}")
    two = isinstance(page_tables, TwoLevelTables)
    if two and page_starts is not None:
        raise ValueError(
            "a TwoLevelTables walk carries its own per-block starts — "
            "page_starts is the flat-table contract")
    if sinks is not None and windows is None:
        raise ValueError(
            "sinks only pin attention-sink pages against a sliding "
            "window — pass windows with them")
    walk = ("two_level" if two else "starts"
            if page_starts is not None or windows is not None else "flat")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        if walk != "flat":
            return paged_windowed_reference(
                q, k_pages, v_pages, page_tables, lengths, q_lengths,
                page_starts, windows, sinks, scale, k_scales, v_scales)
        if Sq == 1:
            return paged_decode_reference(q, k_pages, v_pages, page_tables,
                                          lengths, scale, k_scales, v_scales)
        return paged_verify_reference(q, k_pages, v_pages, page_tables,
                                      lengths, q_lengths, scale, k_scales,
                                      v_scales)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    B, _, _, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    lens = _int32(lengths, q.device).reshape(-1)
    qlens = None if q_lengths is None else _int32(q_lengths,
                                                  q.device).reshape(-1)
    variant = ("verify" if Sq > 1 else "decode") \
        + ("_i8" if quantized else "_f32")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if walk == "flat":
        tables = _int32(page_tables, q.device)
        _check(q, k_pages, v_pages, tables, lens, qlens, k_scales, v_scales)
        entry = variant
        if variant == "decode_f32":
            args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    B, Hkv, G, P, page_size, tables.shape[1], D,
                    float(scale), stream)
        else:
            args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    ptr(k_scales), ptr(v_scales), tables.data_ptr(),
                    lens.data_ptr(), ptr(qlens), out.data_ptr(),
                    B, Hkv, G, Sq, P, page_size, tables.shape[1], D,
                    float(scale), stream)
    else:
        tables, l2, starts, bs, win, snk = _walk_operands(
            page_tables, page_starts, windows, sinks, B, page_size, q.device)
        # _check sees the flat view's shape: [B, max_pages]
        _check(q, k_pages, v_pages, tables, lens, qlens, k_scales, v_scales)
        max_pages = tables.shape[1] * (bs or 1)
        n_blocks = l2.shape[0] if l2 is not None else 0
        entry = "walk_i8" if quantized else "walk_f32"
        args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                ptr(k_scales), ptr(v_scales), tables.data_ptr(), ptr(l2),
                starts.data_ptr(), lens.data_ptr(), ptr(qlens), ptr(win),
                ptr(snk), out.data_ptr(), B, Hkv, G, Sq, P, page_size,
                max_pages, bs, n_blocks, D, float(scale), stream)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = _entry(entry)(*args)
    _build.check(err, "paged_" + entry)
    counts = paged_decode_attention
    counts.launches += 1
    counts.launches_by_variant[variant] += 1
    counts.launches_by_table[walk] += 1
    counts.windowed_launches += int(windows is not None)
    return out


def reset_launches() -> None:
    """Zero the launch counters (total, by variant, by walk, windowed)."""
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
    paged_decode_attention.launches_by_table = dict.fromkeys(TABLE_WALKS, 0)
    paged_decode_attention.windowed_launches = 0


reset_launches()
