"""Threefry-2x32 over torch integer tensors: the counter-based stream that
``jax.random`` draws from, so the port's sampler keys every draw exactly
as the JAX package does.

A key is a [..., 2] int64 tensor holding two uint32 words (int64 because
``torch.uint32`` lacks most arithmetic; every result is masked back to
32 bits).  Every function is vectorised over the leading dimensions and
runs on the device of its tensors, with no Python loop over rows:

- ``key(seed)``: ``jax.random.PRNGKey(seed)`` for a uint32 seed, (0, seed);
- ``fold_in(key, data)``: ``jax.random.fold_in``, threefry of (0, data);
- ``bits(key, n)``: ``jax.random.bits(key, (n,), uint32)`` under
  ``jax_threefry_partitionable`` (JAX's default): counter i is the word
  pair (i >> 32, i & 0xFFFFFFFF) and the draw is the two outputs XORed;
- ``uniform(key, n)`` and ``gumbel(key, n)``: ``jax.random.uniform`` on
  [0, 1) and ``jax.random.gumbel`` (its default "low" mode), float32 from
  the top 23 bits.  ``gumbel``'s two logs may differ from XLA's in their
  last ulps; the bits and the uniforms are bit-equal.
"""

from __future__ import annotations

import torch

__all__ = ["bits", "fold_in", "gumbel", "key", "threefry2x32", "uniform"]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FLOAT_ONE = 0x3F800000  # float32 1.0's bits
_TINY = torch.finfo(torch.float32).tiny


def _rounds(x0, x1, rotations):
    for r in rotations:
        x0 = (x0 + x1) & MASK
        x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the
    key words (k0, k1); all int64 holding uint32, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROTATIONS[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: torch.Tensor) -> torch.Tensor:
    """[...] uint32 seeds (int64) -> [..., 2] keys, as PRNGKey."""
    seed = seed.long() & MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """[..., 2] keys folded with [...] int64 (or a Python int) uint32
    data, broadcast together.  A Python int stays on the host: no copy
    to the keys' device."""
    data = data.long() & MASK if isinstance(data, torch.Tensor) \
        else int(data) & MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] keys -> [..., n] uint32 words (int64), as
    ``jax.random.bits(key, (n,), uint32)`` for each key."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], i >> 32, i & MASK)
    return y0 ^ y1


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in [0, 1) from their top 23 bits."""
    f = ((words >> 9) | _FLOAT_ONE).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] keys -> [..., n] float32 uniforms on [0, 1)."""
    return _unit_floats(bits(k, n)).clamp_min(0.0)


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """[..., 2] keys -> [..., n] float32 standard Gumbel draws."""
    # jax.random.uniform(minval=tiny, maxval=1): u * (1 - tiny) + tiny in
    # float32, where 1 - tiny rounds to 1
    u = (_unit_floats(bits(k, n)) + _TINY).clamp_min(_TINY)
    return -torch.log(-torch.log(u))
