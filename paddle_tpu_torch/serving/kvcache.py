"""Paged KV-cache pool (counterpart of paddle_tpu/serving/kvcache.py,
reduced to what continuous batching with speculation and a prefix
cache calls).

The pool is one preallocated torch tensor per K and V of shape
``[num_layers, H_kv, num_pages, page_size, head_dim]`` on the pool's
device — heads outside the page dimension, so one (head, page) block is
a contiguous ``[page_size, head_dim]`` plane, the layout the paged
decode kernel (kernels/csrc/paged_decode.cu) walks.  A sequence owns an
ordered list of page ids (its page table) and a length; appending a
token claims the next slot of its last page and takes a fresh page from
the free list only every ``page_size`` tokens.  Retiring a sequence
returns its pages in O(pages).

Writes are IN PLACE: ``write_kv`` assigns through an index
(``k_pages[layer][:, pages, slots] = k``), where the JAX pool rebuilt
the array functionally with ``.at[layer, :, pages, slots].set(k)``.
Note the indexing differs on purpose: in NumPy/JAX the integer
``layer`` counts as an advanced index, so the advanced indices there are
split by the head slice and the indexed view is ``[T, H, D]``; in torch
the integer selects first, ``pages, slots`` stay adjacent and the view
is ``[H, T, D]`` — so the port transposes the ``[T, H, D]`` rows before
the write.

Pages are REFCOUNTED, the substrate of the prefix cache
(``prefixcache.py``): an allocated page holds one count for its owning
sequence and one more for each reader that shares it read-only — another
sequence (``attach_prefix``) or a prefix-cache entry (``retain_pages``).
Every way a page leaves a table (``free_seq``, ``truncate_seq``,
``evict_interior``, ``release_pages``) drops ONE hold, and only pages
that reach zero return to the free list and clear their int8 scales.  A
shared page is immutable: the first append into a shared, partly filled
tail page copies it onto a fresh page first (copy-on-write, in the same
atomic claim as the append).  Under pressure ``append_tokens`` calls the
registered reclaimers (the prefix cache's LRU eviction) before it raises
PagePoolExhausted.  ``_allocator`` maps each page to the live sequence
whose admission charge covers it; ``uncharged_live_pages`` counts the
table pages no charge covers.

``truncate_seq`` is the speculative rollback: rejected draft tokens
leave the table, each page leaving it dropping one hold.

``evict_interior`` is sliding-window + attention-sink eviction: the pages a
windowed decode can never attend again leave the table, which is then
compacted, and the kept pages' token positions move into the handle's
explicit ``starts``.  ``page_tables_with_starts`` and
``two_level_tables`` are the batch views the windowed kernel walks.

``dtype="bfloat16"`` pools hold K/V rounded to bf16 (to nearest even, as
the JAX pool's ``.at[].set`` into a bf16 array rounds).
``dtype="int8"`` pools hold amax-quantized pages with one fp32 scale per
(layer, page) for each of K and V, in ``k_scales``/``v_scales`` [L, P]
on the pool's DEVICE (0 = no content), where the JAX pool keeps them in
host numpy.  ``write_kv`` quantizes with the JAX pool's arithmetic (see
``_quantized_write``); freed, truncated-away and scrubbed pages clear
their scales.

Left for later slices: export and import (tiered KV, fleet handoff),
defrag and its remap hook, and ``reclaim_orphans``.  The pool is driven
from one thread (the decode loop) and takes no lock.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.paged_attention import PAD_START, TwoLevelTables, _group_size

__all__ = ["KVCachePool", "PagePoolExhausted", "SequenceHandle"]


class PagePoolExhausted(RuntimeError):
    """No free page to satisfy an append — the admission controller must
    retire or refuse sequences before this fires mid-decode."""


@dataclasses.dataclass
class SequenceHandle:
    """Per-sequence page table: ordered page ids + token count.

    ``starts`` is the absolute token position of each page's slot 0.
    None, the common case, means the implicit ``i * page_size``; it
    becomes explicit the first time eviction drops interior pages, after
    which the table holds live pages only.  Every start is a multiple of
    page_size, they rise strictly, and the tail page is never evicted, so
    the append slot (``length % page_size``) is the same either way."""

    seq_id: int
    pages: List[int] = dataclasses.field(default_factory=list)
    length: int = 0
    starts: Optional[List[int]] = None

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size

    def page_starts(self, page_size: int) -> List[int]:
        """Absolute slot-0 positions, explicit or implicit."""
        if self.starts is not None:
            return self.starts
        return [i * page_size for i in range(len(self.pages))]

    def tail_free_slots(self, page_size: int) -> int:
        """Unclaimed slots in the tail page: the append-side room, right
        after eviction too (``capacity`` counts resident pages, which is
        less than an evicted table's extent)."""
        if not self.pages:
            return 0
        last = (self.starts[-1] if self.starts is not None
                else (len(self.pages) - 1) * page_size)
        return last + page_size - self.length


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


class KVCachePool:
    """Preallocated paged K/V storage for every layer of one model.

    ``dtype`` is "float32" (default), "bfloat16" or "int8" (per-page
    scales).  ``num_heads`` is the model's QUERY head
    count; the pool stores ``num_kv_heads`` (None: num_heads) heads, and
    ``H_q % H_kv != 0`` raises GroupedHeadsError.  ``device=None`` is
    the card (raises without one); pass ``device="cpu"`` explicitly for
    the CPU."""

    def __init__(self, num_pages: int, page_size: int, num_layers: int,
                 num_heads: int, head_dim: int,
                 num_kv_heads: Optional[int] = None, device=None,
                 dtype="float32"):
        if num_pages < 1 or page_size < 1:
            raise ValueError("num_pages and page_size must be >= 1")
        name = str(dtype).replace("torch.", "")
        if name not in _DTYPES:
            raise ValueError(f"pool dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.device = resolve_device(device)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads
                                if num_kv_heads is not None else num_heads)
        _group_size(self.num_heads, self.num_kv_heads)  # typed raise
        self.head_dim = int(head_dim)
        shape = (self.num_layers, self.num_kv_heads, self.num_pages,
                 self.page_size, self.head_dim)
        self.k_pages = torch.zeros(shape, dtype=_DTYPES[name],
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=_DTYPES[name],
                                   device=self.device)
        self.quantized = name == "int8"
        if self.quantized:
            self.k_scales = torch.zeros(self.num_layers, self.num_pages,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        else:
            self.k_scales = self.v_scales = None
        # LIFO free list: recently freed pages are reused first
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._tables: Dict[int, SequenceHandle] = {}
        # per-page holds: 0 free, 1 one owner, > 1 shared read-only
        self._ref: List[int] = [0] * self.num_pages
        # page -> the live sequence whose admission charge covers it
        self._allocator: Dict[int, int] = {}
        # fn(pages_short) -> pages freed, called before PagePoolExhausted
        self._reclaim_hooks: List[Callable[[int], int]] = []
        # fn() -> {page: holds} no table explains (prefix-cache entries)
        self._owner_hooks: List[Callable[[], Dict[int, int]]] = []
        self._index_memo = None  # write_kv's last (pages, slots, index)
        self._stats = {"page_allocs": 0, "page_frees": 0, "token_appends": 0,
                       "used_pages_high_water": 0, "tokens_truncated": 0,
                       "pages_evicted": 0, "cow_copies": 0,
                       "shared_attach_pages": 0}

    # -- sizing ---------------------------------------------------------

    @classmethod
    def pages_needed(cls, tokens: int, page_size: int) -> int:
        """ceil(tokens / page_size) — the admission controller's unit."""
        return -(-int(tokens) // int(page_size))

    def bytes_per_page(self) -> int:
        """One page's K+V bytes over all layers, at the pool's element
        size; an int8 pool adds its fp32 K and V scale per layer."""
        nbytes = (2 * self.num_layers * self.page_size * self.num_kv_heads
                  * self.head_dim * self.k_pages.element_size())
        if self.quantized:
            nbytes += 2 * self.num_layers * 4
        return nbytes

    def layer_scales(self, layer: int):
        """(k_scales [P], v_scales [P]) of one layer of an int8 pool, the
        dequantization operands of paged_decode_attention and
        gather_kv_pages; (None, None) for a float32 pool.  These are
        views, read by later work in stream order (the JAX pool hands
        out host copies)."""
        if not self.quantized:
            return None, None
        return self.k_scales[layer], self.v_scales[layer]

    def _clear_scales(self, pages: Sequence[int]) -> None:
        """Drop the scale entries of pages leaving their owner: a page
        on the free list carries no scale (check_invariants audits it)."""
        if self.quantized and len(pages):
            idx = torch.as_tensor(list(pages), dtype=torch.long,
                                  device=self.device)
            self.k_scales[:, idx] = 0.0
            self.v_scales[:, idx] = 0.0

    # -- lifecycle ------------------------------------------------------

    def allocate(self, seq_id: int) -> SequenceHandle:
        """Register a sequence with an empty page table."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        h = SequenceHandle(seq_id)
        self._tables[seq_id] = h
        return h

    def _drop_holds(self, seq_id: Optional[int],
                    pages: Sequence[int]) -> List[int]:
        """Drop one hold on each of ``pages`` (in the order given), held by
        sequence ``seq_id`` (None: by no sequence): a page that reaches
        zero returns to the free list with its scales cleared; one that
        readers keep alive loses its charge if this sequence carried it.
        Returns the freed pages."""
        freed: List[int] = []
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] <= 0:
                self._ref[p] = 0
                self._free.append(p)
                self._allocator.pop(p, None)
                freed.append(p)
            elif seq_id is not None and self._allocator.get(p) == seq_id:
                del self._allocator[p]
        self._clear_scales(freed)
        self._stats["page_frees"] += len(freed)
        return freed

    def free_seq(self, seq_id: int) -> int:
        """Retire a sequence: each of its pages drops one hold, and only
        pages that reach zero return to the free list (pages shared with
        the prefix cache or other sequences stay live).  Returns the
        number of pages freed."""
        h = self._tables.pop(seq_id)
        return len(self._drop_holds(seq_id, list(reversed(h.pages))))

    def truncate_seq(self, seq_id: int, length: int) -> int:
        """Shrink a sequence's table to ``length`` tokens: the
        speculative rollback of rejected draft tokens.  Pages past
        ceil(length / page_size) leave the table, each dropping one hold
        (LIFO, as free_seq drops them): only pages that reach zero are
        freed, their scales cleared; the kept tail page's surplus slots
        hold stale content that the length masks and the next append
        overwrites.  On an evicted table
        the pages whose start lies below ``length`` stay, and a length
        inside a dropped interior gap raises.  Returns the number of
        pages freed.  ``length`` must lie in [0, current length]: growth
        is append_tokens' job."""
        h = self._tables[seq_id]
        n = int(length)
        if n < 0 or n > h.length:
            raise ValueError(
                f"cannot truncate sequence {seq_id} from {h.length} to "
                f"{n} tokens — length must shrink into [0, {h.length}]")
        if n == h.length:
            return 0
        if h.starts is None:
            keep = self.pages_needed(n, self.page_size)
        else:
            # a rollback removes just-appended tail tokens, so the new
            # length must land inside a kept page: a dropped interior gap
            # has no page to hold it
            keep = sum(1 for st in h.starts if st < n)
            if n and (not keep
                      or n > h.starts[keep - 1] + self.page_size):
                raise ValueError(
                    f"cannot truncate evicted sequence {seq_id} to {n} "
                    "tokens — that position falls in a dropped interior "
                    "gap")
            h.starts = h.starts[:keep]
        dropped = h.pages[keep:]
        h.pages = h.pages[:keep]
        self._stats["tokens_truncated"] += h.length - n
        h.length = n
        return len(self._drop_holds(seq_id, list(reversed(dropped))))

    def evict_interior(self, seq_id: int, window: int,
                       sinks: int = 0) -> int:
        """Sliding-window + attention-sink eviction: drop the pages a
        windowed decode can never attend again.  A page starting at
        token ``st`` goes iff it lies past the sinks (``st >= sinks``)
        and wholly outside every future query's window (``st + page_size
        <= length - window``; window >= 1 keeps the tail page, and the
        window's trailing edge only moves forward).  The kept pages'
        positions move into the handle's ``starts``; each dropped page
        drops one hold (in reversed order, as truncate_seq drops them),
        and only those that reach zero are freed.  Returns the number of
        pages dropped from this table (also counted in
        ``stats()["pages_evicted"]``)."""
        window = int(window)
        sinks = int(sinks)
        if window < 1:
            raise ValueError(f"window must be >= 1 token, got {window}")
        if sinks < 0:
            raise ValueError(f"sinks must be >= 0 tokens, got {sinks}")
        h = self._tables[seq_id]
        starts = h.page_starts(self.page_size)
        keep = [i for i, st in enumerate(starts)
                if st < sinks or st + self.page_size > h.length - window]
        if len(keep) == len(h.pages):
            return 0
        kept = set(keep)
        dropped = [p for i, p in enumerate(h.pages) if i not in kept]
        h.starts = [starts[i] for i in keep]
        h.pages = [h.pages[i] for i in keep]
        self._drop_holds(seq_id, list(reversed(dropped)))
        self._stats["pages_evicted"] += len(dropped)
        return len(dropped)

    # -- sharing (the prefix-cache substrate) ---------------------------

    def attach_prefix(self, seq_id: int, pages: Sequence[int],
                      length: int) -> None:
        """Attach already-written pages read-only to a sequence with an
        empty table: each page gains one hold and the sequence starts at
        ``length`` tokens, which must land in the last page — the prefix
        cache's hit path, with no free-list pressure."""
        pages = [int(p) for p in pages]
        if length < 1 or not pages:
            raise ValueError("attach_prefix needs pages covering >= 1 token")
        cap = len(pages) * self.page_size
        if not cap - self.page_size < length <= cap:
            raise ValueError(
                f"length {length} does not land in the last of "
                f"{len(pages)} pages (page_size {self.page_size})")
        h = self._tables[seq_id]
        if h.pages or h.length:
            raise ValueError(
                f"sequence {seq_id} already holds pages — prefixes attach "
                "only at admission")
        for p in pages:
            if not 0 <= p < self.num_pages or self._ref[p] < 1:
                raise ValueError(f"page {p} is not live — cannot share a "
                                 "free or out-of-range page")
        for p in pages:
            self._ref[p] += 1
        h.pages = list(pages)
        h.length = int(length)
        self._stats["shared_attach_pages"] += len(pages)

    def retain_pages(self, pages: Sequence[int]) -> None:
        """One more hold on each live page (a prefix-cache entry pinning
        a prompt's page)."""
        for p in pages:
            if not 0 <= int(p) < self.num_pages or self._ref[int(p)] < 1:
                raise ValueError(f"page {p} is not live")
        for p in pages:
            self._ref[int(p)] += 1

    def release_pages(self, pages: Sequence[int], scrub: bool = False) -> int:
        """Drop one hold on each page; pages that reach zero return to the
        free list.  With ``scrub`` their K/V content is zeroed first, so a
        page dropped on suspicion of poison never carries non-finite
        values to its next owner (masked attention multiplies unwritten
        slots by zero weights, and 0 * NaN is NaN).  Returns how many
        pages were freed."""
        freed = self._drop_holds(None, [int(p) for p in pages])
        if scrub and freed:
            self._scrub(freed)
        return len(freed)

    def _scrub(self, pages: Sequence[int]) -> None:
        """Zero the K/V content of ``pages`` and their scales (a scrubbed
        int8 page dequantizes to exactly zero)."""
        idx = torch.as_tensor(list(pages), dtype=torch.long,
                              device=self.device)
        self.k_pages[:, :, idx] = 0
        self.v_pages[:, :, idx] = 0
        self._clear_scales(pages)

    def scrub_seq_pages(self, seq_id: int) -> int:
        """Zero the content and scales of a live sequence's pages that it
        alone holds (refcount 1) — the quarantine path calls this before
        free_seq so non-finite K/V (or a NaN scale) never reaches the
        next owner of the page.  Shared pages are left to their other
        readers.  Returns how many pages were scrubbed."""
        own = [p for p in self._tables[seq_id].pages if self._ref[p] == 1]
        if own:
            self._scrub(own)
        return len(own)

    def refcount(self, page: int) -> int:
        return self._ref[int(page)]

    def table_snapshot(self, seq_id: int) -> Tuple[List[int], int]:
        """(pages, length): a copy of one sequence's table."""
        h = self._tables[seq_id]
        return list(h.pages), h.length

    def uncharged_live_pages(self) -> int:
        """Distinct pages in live tables whose charging sequence has
        retired (attached prefixes the cache kept alive past their
        allocator).  No admission charge covers them, and no reclaimer may
        free them while a reader lives, so admission sets this many
        aside."""
        live = {p for h in self._tables.values() for p in h.pages}
        return sum(1 for p in live if p not in self._allocator)

    def register_reclaimer(self, fn: Callable[[int], int]) -> None:
        """``fn(pages_short) -> freed`` runs when an append finds too few
        free pages (the prefix cache's LRU eviction), before
        PagePoolExhausted."""
        self._reclaim_hooks.append(fn)

    def register_owner(self, fn: Callable[[], Dict[int, int]]) -> None:
        """``fn() -> {page: holds}`` explains holds no table covers (the
        prefix cache's entries) to check_invariants."""
        self._owner_hooks.append(fn)

    def append_token(self, seq_ids: Sequence[int]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Claim the next (page, slot) for one new token on every sequence.
        Returns (pages [B], slots [B]) int32.  Raises PagePoolExhausted
        before mutating any table."""
        return self.append_tokens(seq_ids, [1] * len(seq_ids))

    def append_tokens(self, seq_ids: Sequence[int], counts: Sequence[int]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Claim (page, slot)s for counts[i] new tokens on sequence i in ONE
        atomic step.  Returns (pages [T], slots [T]) int32 flattened in
        (sequence order, token order).  A shared, partly filled tail page
        is copied onto a fresh page before the first append into it
        (counted in the claim).  Short of pages, the reclaimers run first;
        PagePoolExhausted is raised before any table changes."""
        counts = [int(c) for c in counts]
        if len(counts) != len(seq_ids) or any(c < 0 for c in counts):
            raise ValueError("counts must align with seq_ids and be >= 0")
        need = 0
        for s, c in zip(seq_ids, counts):
            h = self._tables[s]
            free_slots = h.tail_free_slots(self.page_size)
            if c > 0 and free_slots and self._ref[h.pages[-1]] > 1:
                need += 1  # the copy-on-write of the shared tail
            if c > free_slots:
                need += self.pages_needed(c - free_slots, self.page_size)
        for fn in self._reclaim_hooks:
            if need <= len(self._free):
                break
            fn(need - len(self._free))
        if need > len(self._free):
            raise PagePoolExhausted(
                f"pool: need {need} fresh pages for "
                f"{sum(counts)} appends but only {len(self._free)} free of "
                f"{self.num_pages}")
        pages = np.empty(sum(counts), np.int32)
        slots = np.empty(sum(counts), np.int32)
        i = 0
        for s, c in zip(seq_ids, counts):
            h = self._tables[s]
            if (c > 0 and h.tail_free_slots(self.page_size)
                    and self._ref[h.pages[-1]] > 1):
                self._cow_tail(h)
            for _ in range(c):
                if h.tail_free_slots(self.page_size) == 0:
                    p = self._free.pop()
                    self._ref[p] = 1
                    self._allocator[p] = h.seq_id
                    h.pages.append(p)
                    if h.starts is not None:
                        # evicted table: the fresh tail page starts at the
                        # current length (a page multiple: the tail was full)
                        h.starts.append(h.length)
                    self._stats["page_allocs"] += 1
                pages[i] = h.pages[-1]
                slots[i] = h.length % self.page_size
                h.length += 1
                i += 1
        self._stats["token_appends"] += sum(counts)
        self._stats["used_pages_high_water"] = max(
            self._stats["used_pages_high_water"], self.used_pages)
        return pages, slots

    def _cow_tail(self, h: SequenceHandle) -> None:
        """Copy-on-write of a sequence's shared, partly filled tail page:
        a fresh page takes the content of every layer of K and V (and an
        int8 page's scales), the original drops this sequence's hold, and
        the table's tail becomes the copy."""
        old = h.pages[-1]
        new = self._free.pop()
        self._ref[new] = 1
        self._allocator[new] = h.seq_id
        self._ref[old] -= 1
        self.k_pages[:, :, new] = self.k_pages[:, :, old]
        self.v_pages[:, :, new] = self.v_pages[:, :, old]
        if self.quantized:
            self.k_scales[:, new] = self.k_scales[:, old]
            self.v_scales[:, new] = self.v_scales[:, old]
        h.pages[-1] = new
        self._stats["page_allocs"] += 1
        self._stats["cow_copies"] += 1

    def write_kv(self, layer: int, pages, slots, k: torch.Tensor,
                 v: torch.Tensor) -> None:
        """Write token K/V for ``layer`` in place: k/v [T, H_kv, D] into the
        claimed (page, slot)s (distinct pairs, as append_tokens returns
        them, as host arrays or tensors).  An int8 pool amax-quantizes on
        the way in; a bf16 pool rounds to nearest even."""
        pg, sl, upages, inv = self._write_index(pages, slots)
        if self.quantized:
            self._quantized_write(self.k_pages[layer], self.k_scales[layer],
                                  pg, sl, upages, inv, k)
            self._quantized_write(self.v_pages[layer], self.v_scales[layer],
                                  pg, sl, upages, inv, v)
            return
        # torch keeps `pages, slots` adjacent after the head slice: the
        # indexed view is [H, T, D] (module docstring)
        dt = self.k_pages.dtype
        self.k_pages[layer][:, pg, sl] = k.transpose(0, 1).to(dt)
        self.v_pages[layer][:, pg, sl] = v.transpose(0, 1).to(dt)

    def _write_index(self, pages, slots):
        """(pages, slots) as long tensors on the pool's device and, for an
        int8 pool, the touched pages and each row's index among them
        (np.unique on the host: on the device its size would cost a
        sync).  A step writes every layer at the same (page, slot)s, so
        the last call's result is reused while the same values come back:
        one conversion a step, not one a layer."""
        host = [a.cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a) for a in (pages, slots)]
        memo = self._index_memo
        if memo is not None and all(np.array_equal(m, h)
                                    for m, h in zip(memo[0], host)):
            return memo[1]

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=self.device)

        upages = inv = None
        if self.quantized:
            upages, inv = np.unique(host[0], return_inverse=True)
            upages, inv = dev(upages), dev(inv.reshape(-1))
        out = (dev(host[0]), dev(host[1]), upages, inv)
        self._index_memo = ([h.copy() for h in host], out)
        return out

    @staticmethod
    def _quantized_write(arr, scales, pg, sl, upages, inv, x) -> None:
        """amax-quantize rows x [T, H_kv, D] into the int8 slots of one
        layer (arr [H_kv, P, page_size, D], scales [P]), with the JAX
        pool's arithmetic (``_quantized_write``), on the pool's device
        without a host sync.  ``upages`` are the touched pages and
        ``inv`` each row's index among them.  Per touched page the scale
        is the running max of amax / 127; a scale that GROWS re-quantizes
        the page's existing content by old / new.  Rounding is half to
        even and clips to +-127; a NaN row makes its page's scale NaN (the
        quarantine path scrubs it).  Where the JAX pool re-quantizes only
        the growing pages, this one multiplies every touched page by its
        factor, 1 where the scale did not grow, which gives the same int8
        values (an int8 value times 1 rounds to itself) without a
        data-dependent branch.  Divisions are tensor by tensor: torch's
        CUDA division by a Python scalar multiplies by the reciprocal,
        which can differ in the last bit."""
        x = x.to(torch.float32)
        row_amax = x.abs().amax(dim=(1, 2))  # [T]
        page_amax = row_amax.new_zeros(len(upages)).scatter_reduce(
            0, inv, row_amax, "amax", include_self=True)
        # NaN propagates into the scale explicitly (np.maximum.at does)
        nan_pages = torch.zeros_like(page_amax).index_add_(
            0, inv, row_amax.isnan().to(torch.float32)) > 0
        page_amax = page_amax.masked_fill(nan_pages, float("nan"))
        old = scales[upages]
        new = torch.maximum(old, page_amax / torch.full_like(page_amax,
                                                             127.0))
        requant = (new > old) & (old > 0)
        factor = torch.where(requant, old / torch.where(requant, new, 1.0),
                             torch.ones_like(old))
        block = arr[:, upages].to(torch.float32) * factor[None, :, None, None]
        arr[:, upages] = block.round().clamp(-127, 127).to(torch.int8)
        scales[upages] = new
        row_scale = new[inv]
        safe = torch.where(row_scale > 0, row_scale,
                           torch.ones_like(row_scale))
        q = (x / safe[:, None, None]).round().clamp(-127, 127)
        arr[:, pg, sl] = torch.nan_to_num(q, nan=0.0).to(
            torch.int8).transpose(0, 1)

    # -- read side ------------------------------------------------------

    def page_table_batch(self, seq_ids: Sequence[int]
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(tables [B, max_pages] int32 padded with page 0 — the length
        mask hides the tail — and lengths [B] int32)."""
        handles = [self._tables[s] for s in seq_ids]
        maxp = max((len(h.pages) for h in handles), default=1) or 1
        tables = np.zeros((len(handles), maxp), np.int32)
        lengths = np.empty(len(handles), np.int32)
        for i, h in enumerate(handles):
            tables[i, :len(h.pages)] = h.pages
            lengths[i] = h.length
        return tables, lengths

    def page_tables_with_starts(self, seq_ids: Sequence[int]
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
        """(tables, starts, lengths): page_table_batch plus a [B,
        max_pages] int32 array of each page's slot-0 position, PAD_START
        past each row's pages — the view for the explicit-starts walk,
        whose position mask then holds on an evicted (compacted) table."""
        handles = [self._tables[s] for s in seq_ids]
        maxp = max((len(h.pages) for h in handles), default=1) or 1
        tables = np.zeros((len(handles), maxp), np.int32)
        starts = np.full((len(handles), maxp), PAD_START, np.int32)
        lengths = np.empty(len(handles), np.int32)
        for i, h in enumerate(handles):
            n = len(h.pages)
            tables[i, :n] = h.pages
            starts[i, :n] = h.page_starts(self.page_size)
            lengths[i] = h.length
        return tables, starts, lengths

    def two_level_tables(self, seq_ids: Sequence[int], block_size: int
                         ) -> Tuple[TwoLevelTables, np.ndarray]:
        """(TwoLevelTables, lengths [B]): the batch as an L1 directory [B,
        ceil(max_pages / block_size)] over [n_blocks, block_size] L2 blocks
        of page ids and starts.  Block 0 is the shared pad block (page 0,
        starts PAD_START), and every L1 row pads with it."""
        bs = int(block_size)
        if bs < 1:
            raise ValueError(f"block_size must be >= 1, got {bs}")
        handles = [self._tables[s] for s in seq_ids]
        maxp = max((len(h.pages) for h in handles), default=1) or 1
        n_l1 = self.pages_needed(maxp, bs)
        l2_blocks = [np.zeros(bs, np.int32)]  # the shared pad block
        st_blocks = [np.full(bs, PAD_START, np.int32)]
        l1 = np.zeros((len(handles), n_l1), np.int32)
        lengths = np.empty(len(handles), np.int32)
        for i, h in enumerate(handles):
            sts = h.page_starts(self.page_size)
            for j in range(self.pages_needed(len(h.pages), bs)):
                chunk = h.pages[j * bs:(j + 1) * bs]
                l2b = np.zeros(bs, np.int32)
                stb = np.full(bs, PAD_START, np.int32)
                l2b[:len(chunk)] = chunk
                stb[:len(chunk)] = sts[j * bs:(j + 1) * bs]
                l1[i, j] = len(l2_blocks)
                l2_blocks.append(l2b)
                st_blocks.append(stb)
            lengths[i] = h.length
        return TwoLevelTables(l1=l1, l2=np.stack(l2_blocks),
                              starts=np.stack(st_blocks),
                              block_size=bs), lengths

    def length(self, seq_id: int) -> int:
        return self._tables[seq_id].length

    def max_live_pages(self, seq_ids: Optional[Sequence[int]] = None) -> int:
        """Longest page count of the tables of ``seq_ids`` (None: every
        live table; 0 when none): the width of a step's table walk."""
        hs = (self._tables.values() if seq_ids is None
              else [self._tables[s] for s in seq_ids])
        return max((len(h.pages) for h in hs), default=0)

    # -- accounting -----------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def stats(self) -> Dict[str, int]:
        return dict(self._stats, used_pages=self.used_pages,
                    free_pages=self.free_pages, num_pages=self.num_pages,
                    live_sequences=len(self._tables))

    def check_invariants(self) -> Dict:
        """Audit page ownership against the refcounts: every page is free
        (on the free list exactly once, no holder) or live with a refcount
        equal to its table occurrences plus the registered owners' holds
        (prefix-cache entries) — a page shared by N sequences and the
        cache is N + 1-held and fine.  Every table's length fits its pages
        with no spare whole page; an evicted table's starts are one per
        page, page multiples, strictly rising, with the tail page the one
        covering the length.  An int8 pool also audits its scales
        (``scale_errors``): a free page carrying a scale in any layer, or
        a live written page (one a length covers, or an owner holds) whose
        scales are set in some layers and 0 in others (all 0 is a scrubbed
        page, legitimate).  Returns a report dict — ``ok`` plus the
        violating page / sequence ids."""
        true_refs = [0] * self.num_pages
        double: List[int] = []
        mismatches: List[int] = []
        for h in self._tables.values():
            seen = set()
            for p in h.pages:
                if not 0 <= p < self.num_pages:
                    double.append(p)
                    continue
                if p in seen:
                    double.append(p)  # twice in one table
                seen.add(p)
                true_refs[p] += 1
            if h.starts is None:
                cap = h.capacity(self.page_size)
                if h.length > cap or cap - h.length >= self.page_size:
                    mismatches.append(h.seq_id)
            elif not _starts_ok(h, self.page_size):
                mismatches.append(h.seq_id)
        held = set()
        for fn in self._owner_hooks:
            for p, holds in fn().items():
                if 0 <= int(p) < self.num_pages:
                    true_refs[int(p)] += int(holds)
                    held.add(int(p))
        free_errors: List[int] = []
        seen_free = set()
        for p in self._free:
            if p in seen_free or not 0 <= p < self.num_pages:
                free_errors.append(p)
                continue
            seen_free.add(p)
            if true_refs[p]:
                double.append(p)  # free AND held
        orphaned = [p for p in range(self.num_pages)
                    if not true_refs[p] and p not in seen_free]
        ref_bad = [p for p in range(self.num_pages)
                   if self._ref[p] != true_refs[p]]
        # more holders than the refcount covers: a free would return a
        # page still in use
        double += [p for p in ref_bad if true_refs[p] > self._ref[p]]
        scale_bad: List[int] = []
        if self.quantized:
            written = set(held)
            for h in self._tables.values():
                written.update(
                    h.pages[:self.pages_needed(h.length, self.page_size)])
            ks, vs = self.k_scales.cpu(), self.v_scales.cpu()
            some = ((ks != 0).any(0) | (vs != 0).any(0)).tolist()
            mixed = (((ks != 0).any(0) & (ks == 0).any(0))
                     | ((vs != 0).any(0) & (vs == 0).any(0))).tolist()
            for p in range(self.num_pages):
                if (not true_refs[p] and some[p]) or (p in written
                                                      and mixed[p]):
                    scale_bad.append(p)
        return {
            "ok": not (orphaned or double or free_errors or mismatches
                       or ref_bad or scale_bad),
            "orphaned_pages": orphaned,
            "double_owned_pages": sorted(set(double)),
            "refcount_mismatches": ref_bad,
            "free_list_errors": free_errors,
            "length_mismatches": mismatches,
            "scale_errors": scale_bad,
            "used_pages": self.used_pages,
            "shared_pages": sum(1 for r in true_refs if r > 1),
            "live_sequences": len(self._tables),
        }


def _starts_ok(h: SequenceHandle, page_size: int) -> bool:
    """An evicted table's starts: one per page, each a page multiple,
    strictly rising, and the tail page the one that covers the length
    (eviction never drops the tail)."""
    st = h.starts
    if not st:
        return not (h.length or h.pages)
    return (len(st) == len(h.pages)
            and all(s % page_size == 0 for s in st)
            and all(a < b for a, b in zip(st, st[1:]))
            and st[-1] < h.length <= st[-1] + page_size
            and st[-1] == (KVCachePool.pages_needed(h.length, page_size)
                           - 1) * page_size)
