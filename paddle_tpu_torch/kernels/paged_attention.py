"""Decode attention over a paged KV pool (counterpart of
paddle_tpu/kernels/paged_attention.py, the variant the serving decode
step runs).

``paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
scale)``: one query token per sequence (q [B, H_q, 1, D]) against that
sequence's cached keys and values, which live in pages of one layer of
the pool (k_pages/v_pages [H_kv, P, page_size, D]).  ``page_tables`` is
the flat [B, max_pages] int32 table, zero-padded past each sequence's
pages (the padded entries point at page 0 and are masked by position);
``lengths`` [B] holds the valid token counts.  H_q must be a multiple
of H_kv (GQA): query head h reads KV head h // (H_q / H_kv), and
anything else raises :class:`GroupedHeadsError`.

- On a CUDA tensor it launches ``csrc/paged_decode.cu`` or raises.
  There is no envelope and no fallback: a geometry the kernel does not
  take is an error, not a silent switch to the gather.
- On a CPU tensor it computes :func:`paged_decode_reference`, the plain
  version: gather the pages, ``repeat_kv``, then reference attention
  with ``k_lengths``.

``paged_decode_attention.launches`` counts kernel launches.  Still to
be ported from the JAX kernel: multi-token verify (Sq > 1), int8 pages
with per-page scales, explicit page starts, two-level tables and the
window + sink mask.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .flash_attention import reference_attention

__all__ = ["GroupedHeadsError", "gather_kv_pages", "paged_decode_attention",
           "paged_decode_reference", "repeat_kv"]

_HEAD_DIMS = (64, 128)
_MAX_GROUP_OUTPUTS = 1024  # G * D the kernel's accumulators hold
_MAX_GRID_Y = 65535


class GroupedHeadsError(ValueError):
    """H_q is not a multiple of H_kv: no query-head group maps cleanly
    onto a KV head.  A config error, raised typed."""


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


def gather_kv_pages(pages, page_tables) -> torch.Tensor:
    """pages [H_kv, P, page_size, D] (one layer of the pool) + page_tables
    [B, max_pages] -> contiguous [B, H_kv, max_pages * page_size, D].
    Rows past a sequence's length hold whatever the padding pages hold:
    callers mask them through k_lengths."""
    tables = torch.as_tensor(page_tables, device=pages.device).to(torch.long)
    b, n_pages = tables.shape
    g = pages.index_select(1, tables.reshape(-1))  # [H, B*maxp, ps, D]
    h, _, ps, d = g.shape
    return g.reshape(h, b, n_pages * ps, d).permute(1, 0, 2, 3).contiguous()


def paged_decode_reference(q, k_pages, v_pages, page_tables, lengths,
                           scale=None) -> torch.Tensor:
    """Plain version: gather, repeat_kv, reference attention over the
    valid ``lengths`` keys.  q [B, H_q, 1, D] -> [B, H_q, 1, D]."""
    G = _group_size(q.shape[1], k_pages.shape[0])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = gather_kv_pages(k_pages, page_tables)
    v = gather_kv_pages(v_pages, page_tables)
    k, v = repeat_kv(k, v, G)
    return reference_attention(q, k, v, causal=False, scale=scale,
                               k_lengths=lengths)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("paged_decode").paged_decode_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, tables, lengths, group: int) -> None:
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(
                f"paged_decode takes a float32 pool and query, {name} is "
                f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"pools must be matching [H_kv, P, page_size, D], got "
            f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    B, _, _, D = q.shape
    if k_pages.shape[3] != D:
        raise ValueError(f"pool head_dim {k_pages.shape[3]} != query {D}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode supports head_dim {_HEAD_DIMS}, got {D}")
    if group * D > _MAX_GROUP_OUTPUTS:
        raise ValueError(
            f"group {group} x head_dim {D} exceeds the kernel's "
            f"{_MAX_GROUP_OUTPUTS} accumulators per block")
    if B > _MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid limit {_MAX_GRID_Y}")
    if tables.dim() != 2 or tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError(
            f"tables must be [B={B}, max_pages] and lengths [B], got "
            f"{tuple(tables.shape)} and {tuple(lengths.shape)}")


def paged_decode_attention(q, k_pages, v_pages, page_tables, lengths,
                           scale=None) -> torch.Tensor:
    """q [B, H_q, 1, D]; k_pages/v_pages [H_kv, P, page_size, D];
    page_tables [B, max_pages] int32; lengths [B] (the fed token already
    appended).  Returns [B, H_q, 1, D]."""
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(
            f"decode query must be [B, H, 1, D], got {tuple(q.shape)} — "
            "the multi-token verify variant is not ported yet")
    G = _group_size(q.shape[1], k_pages.shape[0])
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pages, v_pages, page_tables,
                                      lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    tables = torch.as_tensor(page_tables, device=q.device).to(
        torch.int32).contiguous()
    lens = torch.as_tensor(lengths, device=q.device).to(
        torch.int32).reshape(-1).contiguous()
    _check(q, k_pages, v_pages, tables, lens, G)
    B, Hq, _, D = q.shape
    Hkv, P, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # launch on the tensors' card
        err = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                       tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                       B, Hkv, G, P, page_size, tables.shape[1], D,
                       float(scale),
                       torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
