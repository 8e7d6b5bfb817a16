"""Refcounted prefix cache over the paged KV pool (counterpart of
paddle_tpu/serving/prefixcache.py): prompts that share a prefix reuse its
cached K/V pages instead of prefilling it again.

- A prompt splits into page_size-token runs; each run is a trie node
  keyed by a chained hash (sha1 of the namespace, the parent's key and
  this run's tokens) that carries ONE pool page holding the run's K/V for
  every layer.  A match walks the trie for the longest cached prefix and
  checks every hop against the literal tokens, so a hash collision can
  never splice the wrong K/V into a sequence.  The last node of an
  inserted prompt may be partial (the tail that does not fill a page);
  partial nodes are leaves.
- A hit attaches the matched pages read-only to the new sequence
  (``KVCachePool.attach_prefix``); the first append into a shared, partly
  filled tail page copies it (the pool's copy-on-write), so cached
  content never changes.  A match always leaves at least one prompt token
  uncached: the model must run the last prompt token for the first
  generated token's logits.
- An entry holds its page (one refcount); the cache registers as the
  pool's reclaimer, and under pressure releases pages only it holds,
  leaf first, least recently used first.  ``max_pages`` caps the entries
  the same way at insert time.
- The trie is partitioned by ``adapter_id`` (None: the base model): the
  keys depend on it, so a prefix cached under one model variant never
  serves another.
- A sequence that read cached pages and went non-finite invalidates its
  matched chain with every descendant (``quarantine_seq``), scrubbing the
  pages the cache alone held.

The observability and fault-injection calls of the JAX cache, its defrag
remap hook and its corpus drafter (``ngram_continuation``) are not
ported.  The cache is driven from the decode loop's thread, as the pool.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from .kvcache import KVCachePool

__all__ = ["PrefixCache", "PrefixMatch"]


def _chain_key(parent: Optional[str], tokens: Tuple[int, ...],
               ns: str = "") -> str:
    """An entry's name: its parent's name folded with this page's token
    run, salted by the namespace (adapter id)."""
    h = hashlib.sha1()
    h.update(ns.encode())
    h.update(b"\x00")
    h.update((parent or "").encode())
    h.update((",".join(str(t) for t in tokens)).encode())
    return h.hexdigest()[:20]


@dataclasses.dataclass
class PrefixMatch:
    """The longest cached prefix of one prompt: the trie keys walked, the
    pool pages they carry (in prompt order), and the prompt tokens they
    cover (whole pages except a partial leaf; at most len(prompt) - 1)."""

    keys: List[str] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    tokens: int = 0


@dataclasses.dataclass
class _Entry:
    key: str
    parent: Optional[str]
    tokens: Tuple[int, ...]   # this page's literal token run
    page: int                 # pool page holding the run's K/V
    last_used: int
    children: Dict[Tuple[int, ...], str] = dataclasses.field(
        default_factory=dict)
    ns: str = ""              # adapter namespace ("": the base model)


class PrefixCache:
    """Prefix-to-page trie over one :class:`KVCachePool`::

        pool = KVCachePool(...)
        cache = PrefixCache(pool)
        loop = ContinuousBatchingLoop(params, cfg, pool, prefix_cache=cache)

    The constructor registers the cache as the pool's reclaimer and as an
    owner whose entry holds ``check_invariants`` counts."""

    def __init__(self, pool: KVCachePool, max_pages: Optional[int] = None):
        self.pool = pool
        self.max_pages = int(max_pages) if max_pages else 0
        self._entries: Dict[str, _Entry] = {}
        self._roots: Dict[str, Dict[Tuple[int, ...], str]] = {}
        self._seq_keys: Dict[int, List[str]] = {}
        self._tick = 0
        self._stats = {"hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
                       "cached_tokens_served": 0, "invalidations": 0}
        pool.register_reclaimer(self._reclaim)
        pool.register_owner(self._holds)

    # -- admission -------------------------------------------------------

    def match(self, prompt: Sequence[int],
              adapter_id: Optional[str] = None) -> PrefixMatch:
        """The longest cached prefix of ``prompt`` in ``adapter_id``'s
        namespace, page by page, each hop checked against the literal
        tokens, capped at len(prompt) - 1 tokens.  Touches the matched
        entries' LRU clocks; counts nothing (attach and note_miss do)."""
        prompt = [int(t) for t in prompt]
        limit = len(prompt) - 1
        m = PrefixMatch()
        children = self._roots.get(adapter_id or "", {})
        pos = 0
        while pos < limit:
            best: Optional[_Entry] = None
            for toks, key in children.items():
                if pos + len(toks) > limit:
                    continue
                if tuple(prompt[pos:pos + len(toks)]) != toks:
                    continue
                if best is None or len(toks) > len(best.tokens):
                    best = self._entries[key]
            if best is None:
                break
            m.keys.append(best.key)
            m.pages.append(best.page)
            pos += len(best.tokens)
            best.last_used = self._tick
            self._tick += 1
            children = best.children
            if len(best.tokens) < self.pool.page_size:
                break  # partial nodes are leaves
        m.tokens = pos
        return m

    def attach(self, seq_id: int, m: PrefixMatch) -> int:
        """Attach a match to a freshly allocated sequence (its pages join
        the table read-only; the sequence starts at ``m.tokens``).
        Returns the cached token count; an empty match counts a miss."""
        if not m.tokens:
            self.note_miss()
            return 0
        self.pool.attach_prefix(seq_id, m.pages, m.tokens)
        self._seq_keys[seq_id] = list(m.keys)
        self._stats["hits"] += 1
        self._stats["cached_tokens_served"] += m.tokens
        return m.tokens

    def note_miss(self) -> None:
        self._stats["misses"] += 1

    # -- insertion ---------------------------------------------------------

    def insert(self, seq_id: int, prompt: Sequence[int],
               adapter_id: Optional[str] = None) -> int:
        """Cache a finished prefill's prompt pages: walk and extend the
        trie page by page, each new entry taking one hold on its page.
        The sequence decodes on; its next append into a held partial tail
        page copies it.  Returns the number of entries created."""
        prompt = [int(t) for t in prompt]
        ps = self.pool.page_size
        ns = adapter_id or ""
        created = 0
        pages, length = self.pool.table_snapshot(seq_id)
        if length < len(prompt):
            raise ValueError(
                f"sequence {seq_id} holds {length} tokens < prompt "
                f"{len(prompt)} — insert only after prefill completes")
        children = self._roots.setdefault(ns, {})
        parent: Optional[str] = None
        pos = idx = 0
        while pos < len(prompt):
            n = min(ps, len(prompt) - pos)
            toks = tuple(prompt[pos:pos + n])
            key = children.get(toks)
            if key is not None:
                e = self._entries[key]
            else:
                page = pages[idx]
                self.pool.retain_pages([page])
                key = _chain_key(parent, toks, ns)
                e = _Entry(key=key, parent=parent, tokens=toks, page=page,
                           last_used=self._tick, ns=ns)
                self._entries[key] = e
                children[toks] = key
                created += 1
                self._stats["inserts"] += 1
            e.last_used = self._tick
            self._tick += 1
            parent, children = key, e.children
            pos += n
            idx += 1
            if n < ps:
                break  # the partial tail is this prompt's leaf
        if self.max_pages:
            while len(self._entries) > self.max_pages:
                # -1: nothing evictable; 0: an entry went but its page
                # stays attached elsewhere — go on
                if self._evict_one(require_free=False) < 0:
                    break
        return created

    # -- eviction and invalidation -----------------------------------------

    def _evict_one(self, require_free: bool) -> int:
        """Evict the least recently used leaf entry; with ``require_free``
        only one whose page the cache alone holds (refcount 1).  Returns
        the pages freed (0 when the page stays live), -1 when nothing is
        evictable."""
        best: Optional[_Entry] = None
        for e in self._entries.values():
            if e.children:
                continue
            if require_free and self.pool.refcount(e.page) != 1:
                continue
            if best is None or e.last_used < best.last_used:
                best = e
        if best is None:
            return -1
        self._drop_entry(best)
        freed = self.pool.release_pages([best.page])
        self._stats["evictions"] += 1
        return freed

    def _drop_entry(self, e: _Entry) -> None:
        self._entries.pop(e.key, None)
        siblings = (self._entries[e.parent].children
                    if e.parent in self._entries
                    else self._roots.get(e.ns, {}))
        if siblings.get(e.tokens) == e.key:
            siblings.pop(e.tokens, None)

    def _reclaim(self, short: int) -> int:
        """The pool's pressure hook: release LRU cache-only pages until
        ``short`` pages came free or nothing evictable is left."""
        freed = 0
        while freed < short:
            got = self._evict_one(require_free=True)
            if got < 0:
                break
            freed += got
        return freed

    def _invalidate_tree(self, key: str) -> int:
        e = self._entries.get(key)
        if e is None:
            return 0
        n = 0
        for ck in list(e.children.values()):
            n += self._invalidate_tree(ck)
        self._drop_entry(e)
        # scrubbed on free: the chain goes on suspicion of poison
        self.pool.release_pages([e.page], scrub=True)
        self._stats["invalidations"] += 1
        return n + 1

    def quarantine_seq(self, seq_id: int) -> int:
        """A sequence served from this cache went non-finite: invalidate
        its matched chain and every descendant.  Pages still attached to
        live sequences stay alive through their tables' holds.  Returns
        the entries invalidated."""
        keys = self._seq_keys.pop(seq_id, [])
        return self._invalidate_tree(keys[0]) if keys else 0

    def forget_seq(self, seq_id: int) -> None:
        """Drop a retired sequence's matched-chain record."""
        self._seq_keys.pop(seq_id, None)

    def clear(self) -> int:
        """Release every entry; after it a healthy run's pool is free
        again.  Returns the entries released."""
        n = 0
        for roots in list(self._roots.values()):
            for key in list(roots.values()):
                n += self._invalidate_tree(key)
        self._seq_keys.clear()
        self._roots.clear()
        return n

    # -- pool integration and introspection --------------------------------

    def _holds(self) -> Dict[int, int]:
        """The owner hook of check_invariants: one hold per entry page."""
        holds: Dict[int, int] = {}
        for e in self._entries.values():
            holds[e.page] = holds.get(e.page, 0) + 1
        return holds

    def locked_pages(self) -> int:
        """Distinct entry pages attached to at least one live sequence
        (refcount > 1)."""
        return sum(1 for e in self._entries.values()
                   if self.pool.refcount(e.page) > 1)

    def stats(self) -> Dict[str, int]:
        return dict(self._stats, entries=len(self._entries),
                    locked_pages=self.locked_pages())
