"""Draft-model-free speculative drafting: prompt-lookup n-grams
(counterpart of paddle_tpu/serving/speculative.py, which is pure host
code; the port keeps its own copy so that it imports nothing of the
JAX package).

Decode is bandwidth-bound: every model step streams the weights and the
live KV pages to produce ONE token per sequence.  The multi-token verify
step (``TransformerDecoder.verify_step``, the ``q_lengths`` variant of
the paged kernel) can commit up to d+1 tokens for nearly the same KV
traffic, if something proposes plausible continuations.  PROMPT LOOKUP
proposes them for free on templated prompts, code, retrieval contexts
and multi-turn chat, which repeat themselves: match the last ``n``
committed tokens against the prompt + generation history, and propose
the tokens that followed the most recent earlier occurrence.

The drafter is host bookkeeping only (no device memory, no extra model
step), so a miss costs only the wasted query rows of the verify step,
and acceptance is decided by the verifier, never trusted.

INCREMENTAL INDEX.  With a ``seq_id`` the drafter keeps a per-sequence
suffix map (n-gram -> ascending occurrence positions) updated as tokens
commit: each call diffs the handed context against the cached one at
the longest common prefix, rewinds the index over rolled-back tokens
(``KVCachePool.truncate_seq`` rejections make the next call's context
shorter or diverged, and every n-gram the dead tokens registered pops
back off), then extends it over the new commits.  Per step that is
O(d * max_ngram) map maintenance plus an O(occurrences) probe, where
the stateless scan re-walks the whole history.  The context stays the
source of truth: the index is only an accelerator, and a stateless call
(``seq_id=None``) gives identical proposals.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PromptLookupDrafter"]


class _SeqIndex:
    """One sequence's committed tokens + suffix map.

    ``occ`` maps each n-gram (min_ngram..max_ngram) to the ASCENDING
    list of its occurrence start positions; ``added[j]`` records the
    n-gram keys registered when token j committed (the ones ENDING at
    j), so a rollback pops exactly what the dead tokens added."""

    __slots__ = ("tokens", "occ", "added")

    def __init__(self) -> None:
        self.tokens: List[int] = []
        self.occ: Dict[Tuple[int, ...], List[int]] = {}
        self.added: List[List[Tuple[int, ...]]] = []

    def sync(self, ctx: List[int], min_ngram: int, max_ngram: int) -> None:
        """Re-sync to `ctx`: rewind past the longest common prefix,
        then extend over the new commits."""
        old = self.tokens
        common = 0
        limit = min(len(old), len(ctx))
        while common < limit and old[common] == ctx[common]:
            common += 1
        for j in range(len(old) - 1, common - 1, -1):
            for key in self.added[j]:
                stack = self.occ[key]
                stack.pop()  # occurrences end-ordered: the tail is j's
                if not stack:
                    del self.occ[key]
        del self.tokens[common:]
        del self.added[common:]
        for j in range(common, len(ctx)):
            self.tokens.append(ctx[j])
            keys: List[Tuple[int, ...]] = []
            for n in range(min_ngram, max_ngram + 1):
                i = j - n + 1
                if i < 0:
                    break
                key = tuple(self.tokens[i:j + 1])
                self.occ.setdefault(key, []).append(i)
                keys.append(key)
            self.added.append(keys)


class PromptLookupDrafter:
    """Propose up to ``max_draft`` continuation tokens by n-gram lookup.

    For ``n`` from ``max_ngram`` down to ``min_ngram``: take the last
    ``n`` context tokens as the probe, find its most RECENT earlier
    occurrence in the context, and propose the tokens that followed it.
    Longer probes win; among equal-length matches the most recent wins.
    Returns [] when nothing matches: the loop then feeds that sequence
    a single token, so a drafter never makes a step worse than
    unspeculated decode.

    ``seq_id`` routes the call through the incremental per-sequence
    suffix index (``stateful`` advertises it); the serving loop calls
    :meth:`release` when a sequence retires, and an LRU cap
    (``max_sequences``) bounds host memory regardless.

    ``corpus`` plugs in a SHARED n-gram source: any object exposing
    ``ngram_continuation(probe, limit) -> List[int]`` (the JAX package
    passes its prefix cache's trie; the port has no prefix cache yet
    and its loop passes none).  Own-history matching runs first and a
    full-length own match wins outright; otherwise the corpus is probed
    longest-n-gram first and the LONGER of the two proposals is drafted
    (ties keep own-history)."""

    stateful = True  # the loop may pass seq_id= and call release()
    # source of the most recent proposal ("own" | "corpus"), set by
    # every draft() call
    last_source = "own"
    # draft() takes adapter_id= to confine corpus drafting to one
    # tenant's namespace
    adapter_aware = True

    def __init__(self, max_draft: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1, max_sequences: int = 1024,
                 corpus=None):
        if max_draft < 1:
            raise ValueError(f"max_draft must be >= 1, got {max_draft}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}..{max_ngram}")
        if max_sequences < 1:
            raise ValueError(
                f"max_sequences must be >= 1, got {max_sequences}")
        self.max_draft = int(max_draft)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.max_sequences = int(max_sequences)
        if corpus is not None and not hasattr(corpus,
                                              "ngram_continuation"):
            raise TypeError(
                "corpus must expose ngram_continuation(probe, limit)")
        self.corpus = corpus
        self._index: "OrderedDict[int, _SeqIndex]" = OrderedDict()

    def release(self, seq_id: int) -> None:
        """Drop a retired sequence's index (a no-op for an untracked
        id)."""
        self._index.pop(seq_id, None)

    def tracked_sequences(self) -> int:
        return len(self._index)

    def draft(self, context: Sequence[int], max_draft: int = None,
              seq_id: Optional[int] = None,
              adapter_id: Optional[str] = None) -> List[int]:
        """Propose continuation tokens for `context` (prompt + generated
        history, oldest first).  `max_draft` caps the proposal below
        the drafter's own limit (the loop passes the sequence's
        remaining headroom).  With `seq_id` the incremental index
        answers the probe; without it a one-shot reversed scan does
        (identical output, O(len) per call).  `adapter_id` confines the
        CORPUS probe to that tenant's namespace."""
        limit = self.max_draft if max_draft is None else \
            min(self.max_draft, int(max_draft))
        self.last_source = "own"
        if limit < 1:
            return []
        ctx = [int(t) for t in context]
        if seq_id is None:
            own = self._scan_draft(ctx, limit)
        else:
            idx = self._index.get(seq_id)
            if idx is None:
                idx = _SeqIndex()
                self._index[seq_id] = idx
                while len(self._index) > self.max_sequences:
                    self._index.popitem(last=False)
            else:
                self._index.move_to_end(seq_id)
            idx.sync(ctx, self.min_ngram, self.max_ngram)
            own = self._indexed_draft(idx, ctx, limit)
        if len(own) < limit and self.corpus is not None:
            corp = self._corpus_draft(ctx, limit, adapter_id)
            if len(corp) > len(own):
                self.last_source = "corpus"
                return corp
        return own

    def _corpus_draft(self, ctx: List[int], limit: int,
                      adapter_id: Optional[str] = None) -> List[int]:
        """Probe the shared corpus longest-n-gram first; a full-length
        continuation returns outright, the longest partial one is the
        fallback.  The probe may use the FULL suffix: occurrences there
        are other sequences' chains, so no suffix matches itself."""
        L = len(ctx)
        best: List[int] = []
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            if adapter_id is None:
                # the two-argument form keeps corpora without the
                # adapter_id keyword working
                raw = self.corpus.ngram_continuation(ctx[L - n:], limit)
            else:
                raw = self.corpus.ngram_continuation(
                    ctx[L - n:], limit, adapter_id=adapter_id)
            got = [int(t) for t in raw]
            if len(got) == limit:
                return got
            if len(got) > len(best):
                best = got
        return best

    def _indexed_draft(self, idx: _SeqIndex, ctx: List[int],
                       limit: int) -> List[int]:
        """The scan's decision rule answered from the suffix map: walk
        the probe's occurrences newest-first; a full-length continuation
        wins outright, the longest partial is the cross-n fallback."""
        L = len(ctx)
        best: List[int] = []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            probe = tuple(ctx[L - n:])
            for i in reversed(idx.occ.get(probe, ())):
                if i >= L - n:
                    continue  # the suffix itself is not a match
                out = ctx[i + n:i + n + limit]
                if len(out) == limit:
                    return out
                if len(out) > len(best):
                    best = out
        return best

    def _scan_draft(self, ctx: List[int], limit: int) -> List[int]:
        """Stateless reversed suffix scan, O(len): the seq_id-free path
        and the oracle the index is tested against.  A match too close
        to the end truncates its continuation (a decode cycle's freshest
        match is always near the end), so a full-length continuation
        wins outright and the LONGEST partial one is the fallback."""
        L = len(ctx)
        best: List[int] = []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            probe = ctx[L - n:]
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == probe:
                    out = ctx[i + n:i + n + limit]
                    if len(out) == limit:
                        return out
                    if len(out) > len(best):
                        best = out
        return best
