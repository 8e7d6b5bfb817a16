"""The kernel wrappers' launch counters, read and added to as a whole.

Each wrapper counts its own launches in attributes of its function
(``.launches``, ``.launches_by_dtype``, ``conv_bn_act.layout_copies``,
...).  A CUDA graph launches its kernels without calling the wrappers: a
wrapper ticks once while the graph is captured, and not at all when the
graph is replayed.  ``snapshot()`` reads every counter of the kernel
modules that are loaded, ``difference(before, after)`` is what was
counted between two snapshots, and ``add(counts, times)`` adds ``times``
copies of such a difference: an executor that replays a captured step
makes the counters read the launches that ran (``core/executor.py``).
"""

from __future__ import annotations

import sys
from typing import Dict, Iterator, Tuple

__all__ = ["add", "difference", "snapshot"]

# module -> the wrappers that carry counters (a module that is not loaded
# has launched nothing)
_WRAPPERS = {
    "flash_attention": ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv"),
    "paged_attention": ("paged_decode_attention",),
    "conv_epilogue": ("conv_stats", "bn_epilogue", "conv_bn_act"),
    "corpus": ("corpus_add", "corpus_scale"),
}

Key = Tuple[str, str, str]


def _counters() -> Iterator[Tuple[Key, object]]:
    """((module, wrapper, attribute), wrapper) of every counter: an int or
    a dict of ints whose attribute name says launches or copies."""
    for module, names in _WRAPPERS.items():
        mod = sys.modules.get(f"{__package__}.{module}")
        if mod is None:
            continue
        for name in names:
            fn = getattr(mod, name)
            for attr in list(vars(fn)):
                if "launches" in attr or attr.endswith("_copies"):
                    yield (module, name, attr), fn


def snapshot() -> Dict[Key, object]:
    """Every counter's value now (dicts copied)."""
    out = {}
    for key, fn in _counters():
        value = getattr(fn, key[2])
        out[key] = dict(value) if isinstance(value, dict) else int(value)
    return out


def difference(before: Dict[Key, object],
               after: Dict[Key, object]) -> Dict[Key, object]:
    """What each counter gained from ``before`` to ``after`` (zero
    entries left out)."""
    out = {}
    for key, value in after.items():
        old = before.get(key)
        if isinstance(value, dict):
            old = old or {}
            gained = {k: n - old.get(k, 0) for k, n in value.items()
                      if n != old.get(k, 0)}
            if gained:
                out[key] = gained
        elif value != (old or 0):
            out[key] = value - (old or 0)
    return out


def add(counts: Dict[Key, object], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (a :func:`difference`) to the counters."""
    wrappers = dict(_counters())
    for key, gained in counts.items():
        fn, attr = wrappers[key], key[2]
        if isinstance(gained, dict):
            table = getattr(fn, attr)
            for k, n in gained.items():
                table[k] = table.get(k, 0) + times * n
        else:
            setattr(fn, attr, getattr(fn, attr) + times * gained)
