"""Prefill scheduling arithmetic (counterpart of
paddle_tpu/serving/prefill_sched.py): when a prompt takes the one-pass
whole-prompt prefill, how one chunk step's budget packs over the
still-prefilling sequences, and the per-sequence blast radius of a step
whose logits come back non-finite.  Host Python only.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["evict_nonfinite", "plan_chunks", "whole_eligible"]


def whole_eligible(matched: int, chunk_cap: int) -> bool:
    """True when a prompt takes the one-pass whole-prompt prefill:
    nothing of it is cached (a cached prefix's tail must chunk from its
    match offset) and no chunk cap binds."""
    return matched == 0 and not chunk_cap


def plan_chunks(prompts: Sequence[Sequence[int]],
                positions: Sequence[int], chunk_cap: int,
                flop_budget: Optional[float] = None,
                ) -> Tuple[List[int], List[List[int]], List[int]]:
    """Pack one chunk step's budget over still-prefilling sequences, FIFO,
    clamped per sequence.  A zero cap means one uncapped step that
    finishes every prompt.  Returns ``(idx, chunks, starts)``: ``idx``
    indexes the caller's selection, ``chunks[i]`` is the token run fed
    from position ``starts[i]``.

    ``flop_budget`` counts estimated attention work instead of tokens: a
    chunk of ``n`` tokens from resident position ``pos`` attends over
    about ``n * (pos + n / 2)`` query-key pairs, so the largest ``n``
    within the remaining budget is ``-pos + sqrt(pos^2 + 2 * budget)``.
    The head sequence always gets at least one token (no starvation),
    and a nonzero ``chunk_cap`` still clamps tokens on top."""
    idx: List[int] = []
    chunks: List[List[int]] = []
    starts: List[int] = []
    if flop_budget is not None and flop_budget <= 0:
        raise ValueError(
            f"flop_budget must be > 0 (or None), got {flop_budget}")
    budget = chunk_cap or sum(
        len(p) - pos for p, pos in zip(prompts, positions))
    flops = float(flop_budget) if flop_budget is not None else None
    for i, (prompt, pos) in enumerate(zip(prompts, positions)):
        if budget <= 0 or (flops is not None and flops <= 0 and idx):
            break
        n = min(len(prompt) - pos, budget)
        if flops is not None:
            n_flop = int(-pos + (pos * pos + 2.0 * flops) ** 0.5)
            if not idx:
                n_flop = max(n_flop, 1)  # the head never starves
            n = min(n, n_flop)
        if n <= 0:
            break
        idx.append(i)
        chunks.append(list(prompt[pos:pos + n]))
        starts.append(pos)
        budget -= n
        if flops is not None:
            flops -= n * (pos + n / 2.0)
    return idx, chunks, starts


def evict_nonfinite(pool, cache, seq_ids: Sequence[int],
                    matched: Sequence[int], logits,
                    on_evict: Callable[[int, float], None],
                    ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evict every non-finite row of one step's logits (a tensor, [B, V]
    or [B, Sq, V]): one host copy, then for each poisoned row i its
    sequence's private pages are scrubbed and every page drops its hold,
    its prefix-cache chain is quarantined when it read cached pages
    (``matched[i]``) or forgotten otherwise, and ``on_evict(i, now)``
    does the caller's own bookkeeping.  Returns (host logits, finite [B]
    mask, the step's end after the copy)."""
    host = logits.float().cpu().numpy()
    now = time.perf_counter()  # after the sync: the step's true end
    finite = np.isfinite(host.reshape(len(seq_ids), -1)).all(axis=1)
    for i in np.flatnonzero(~finite):
        sid = seq_ids[i]
        pool.scrub_seq_pages(sid)
        pool.free_seq(sid)
        if cache is not None:
            if matched[i]:
                cache.quarantine_seq(sid)
            else:
                cache.forget_seq(sid)
        on_evict(int(i), now)
    return host, finite, now
