"""The arithmetic of the fp32 flash forward kernel, on the CPU.

``paddle_tpu_torch/kernels/csrc/flash_fwd.cu`` computes the fp32 forward
on the tensor cores with split-TF32 products (tests/tf32_split.py): Q, K,
V and P are split into their tf32 big and small parts and each of S = Q
K^T and O += P V sums small·big + big·small + big·big, small terms first,
in fp32.  One block per 64-query tile, four warps of 16 rows, walks the
keys below ``min(klen, q0 + 64 + Sk - Sq)`` (causal) or ``klen`` in tiles
of 16 keys (head dim 64) or 32 (128) from key 0; a warp skips the 8-key
n-tiles past its rows' last visible key and masks only those that cross a
row's frontier or klen.  Per tile: S (unscaled), the running max m, corr =
exp(scale (m - m_new)), P = exp(scale S - scale m_new), l = corr l + sum
P, acc = corr acc + P V, all fp32; out = acc / max(l, 1e-30), lse = scale
m + log l (+1e30 for a row with no visible key).

``fwd_model`` below is a plain model of exactly that walk and arithmetic,
written here and nowhere else.  It is held against the port's
``flash_attention_fwd_reference`` and against the JAX Pallas forward in
interpret mode (``_pallas_flash(interpret=True, need_lse=True)``), out and
lse, over head dims 64 and 128, causal and not, a klen = 0 row, S off the
tiles, more keys than queries and more queries than keys, under the fp32
gate of ``chip_smoke.py``: max abs error <= 1e-4 * max(1, max |reference|).

A planted fault must FAIL that gate: the same model with two TF32
products a multiply (B's small part dropped), at the training head shape
(S 256, D 64, causal and not); three is the fewest that passes.  The walk
itself is checked by index arithmetic: every visible (query, key) pair
lies in a live n-tile of its warp exactly once, and an n-tile the kernel
leaves unmasked holds visible pairs only.
"""

import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402
from tf32_split import (CASES, FAULT_CASES, H, gate, inputs,  # noqa: E402
                        mm2, mm3)

BQ = 64          # query rows a block
WARP_ROWS = 16   # query rows a warp
WALK = {64: 16, 128: 32}  # keys a walked tile by head dim (FwdCfg<D>)
NT = 8           # keys an n-tile of S (an m16n8 accumulator)
NEG_INF = tflash.NEG_INF

# the backward's cases, and more queries than keys: causal rows that see
# no key at all
FWD_CASES = {**CASES,
             "causal_more_queries_130x70": (1, 130, 70, 64, True, [70])}


def walk(Sq, Sk, klen, causal, key_tile):
    """The kernel's walk over ``key_tile``-key tiles for one batch row:
    ``[(q0, [(k0, live, masked), ...]), ...]`` where ``live[w]`` is the
    number of 8-key n-tiles warp w computes in the tile at k0 and
    ``masked[w][j]`` says whether it masks n-tile j (the kernel's
    ``w_end``, ``w_full`` and ``nj``)."""
    klen = max(0, min(Sk, klen))
    offset = Sk - Sq
    blocks = []
    for q0 in range(0, Sq, BQ):
        k_end = min(klen, q0 + BQ + offset) if causal else klen
        rows = [q0 + WARP_ROWS * w for w in range(BQ // WARP_ROWS)]
        w_end = [min(klen, r + WARP_ROWS + offset) if causal else klen
                 for r in rows]
        w_full = [min(klen, r + 1 + offset) if causal else klen
                  for r in rows]
        tiles = []
        for k0 in range(0, max(k_end, 0), key_tile):
            live = [min(key_tile // NT, max(0, e - k0 + NT - 1) // NT)
                    for e in w_end]
            masked = [[k0 + NT * j + NT > f for j in range(key_tile // NT)]
                      for f in w_full]
            tiles.append((k0, live, masked))
        blocks.append((q0, tiles))
    return blocks


def fwd_model(q, k, v, causal, scale, k_lengths, mm=mm3):
    """(out, lse) of the fp32 forward kernel, warp by warp and tile by
    tile: q/k/v [B, H, S, D] fp32, every product through ``mm``."""
    B, _, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.zeros(B, H, Sq, D)
    lse = torch.full((B, H, Sq), -NEG_INF)
    for b in range(B):
        klen = max(0, min(Sk, int(k_lengths[b])))
        for q0, tiles in walk(Sq, Sk, klen, causal, WALK[D]):
            for w in range(BQ // WARP_ROWS):
                r0 = q0 + WARP_ROWS * w
                if r0 >= Sq:  # rows the kernel computes and never stores
                    continue
                rows = slice(r0, min(r0 + WARP_ROWS, Sq))
                qi = torch.arange(r0, rows.stop)[:, None]
                n = rows.stop - r0
                m = torch.full((H, n, 1), NEG_INF / 2)
                l = torch.zeros(H, n, 1)
                acc = torch.zeros(H, n, D)
                for k0, live, _ in tiles:
                    if live[w] == 0:  # m, l and acc stay: corr = 1, p = 0
                        continue
                    ke = min(Sk, k0 + NT * live[w])
                    s = mm(q[b, :, rows],
                           k[b, :, k0:ke].transpose(-1, -2).contiguous())
                    kj = torch.arange(k0, ke)[None, :]
                    ok = (kj < klen) & ((kj <= qi + Sk - Sq) if causal
                                        else True)
                    s = torch.where(ok, s, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    corr = torch.exp((m - m_new) * scale)
                    p = torch.exp(s * scale - m_new * scale)
                    l = corr * l + p.sum(-1, keepdim=True)
                    acc = corr * acc + mm(p, v[b, :, k0:ke])
                    m = m_new
                denom = l.clamp_min(1e-30)
                out[b, :, rows] = acc / denom
                lse[b, :, rows] = torch.where(
                    l > 0, m * scale + torch.log(denom),
                    torch.tensor(-NEG_INF)).squeeze(-1)
    return out, lse


def _lse_gate(got, want):
    """The fp32 gate on lse over the rows with a visible key; the others
    must be +1e30 exactly."""
    got, want = np.asarray(got), np.asarray(want, np.float32)
    dead = want >= 1e29
    assert (got[dead] == -NEG_INF).all()
    return gate(got[~dead], want[~dead])


@pytest.fixture(scope="module", params=sorted(FWD_CASES))
def case(request):
    """One case: inputs made with numpy, the port's plain forward with lse
    and the JAX Pallas forward in interpret mode."""
    B, Sq, Sk, D, causal, lens = FWD_CASES[request.param]
    x = inputs(100 + sorted(FWD_CASES).index(request.param), B, Sq, Sk, D)
    scale = D ** -0.5
    jout, jlse = jflash._pallas_flash(*(jnp.asarray(a) for a in x),
                                      jnp.asarray(lens, jnp.float32), causal,
                                      scale, interpret=True, need_lse=True)
    jlse = np.array(jlse).reshape(B, H, -1)[:, :, :Sq].copy()
    q, k, v = (torch.from_numpy(a) for a in x)
    kl = torch.tensor(lens, dtype=torch.int32)
    plain = tflash.flash_attention_fwd_reference(q, k, v, causal, scale, kl)
    return dict(name=request.param, lens=lens,
                args=(q, k, v, causal, scale, kl),
                plain=[t.numpy() for t in plain],
                jax=(np.asarray(jout, np.float32), jlse))


def test_fwd_model_matches_plain_and_interpret(case):
    out, lse = fwd_model(*case["args"])
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    for ref_out, ref_lse in (case["plain"], case["jax"]):
        err, bound, ok = gate(out, ref_out)
        assert ok, (case["name"], "out", err, bound)
        err, bound, ok = _lse_gate(lse, ref_lse)
        assert ok, (case["name"], "lse", err, bound)
    for b, n in enumerate(case["lens"]):
        if n == 0:  # a fully masked row: zeros, lse = +1e30
            assert bool((out[b] == 0).all())
            assert bool((lse[b] == -NEG_INF).all())


@pytest.mark.parametrize("case", FAULT_CASES, indirect=True)
def test_two_tf32_products_fail_the_gate(case):
    """Two TF32 products a multiply, at the training head shape: out must
    fail the gate against both references, while the three-product model
    (above) passes it."""
    out, _ = fwd_model(*case["args"], mm=mm2)
    for ref_out, _ in (case["plain"], case["jax"]):
        err, bound, ok = gate(out, ref_out)
        assert not ok, (case["name"], err, bound)


SHAPES = [(Sq, Sk) for Sq in (1, 20, 64, 65, 130, 256)
          for Sk in (1, 31, 64, 70, 129, 150, 256)]


@pytest.mark.parametrize("key_tile", sorted(set(WALK.values())))
@pytest.mark.parametrize("causal", [True, False])
def test_walk_covers_every_visible_pair(causal, key_tile):
    """Index arithmetic alone, over query and key lengths on and off the
    tiles and every klen class: each visible (query, key) pair lies in a
    live n-tile of its warp exactly once, a skipped n-tile holds none, and
    an n-tile the kernel does not mask holds visible pairs only (rows past
    Sq are never stored)."""
    for (Sq, Sk), frac in itertools.product(SHAPES, (0.0, 0.3, 1.0)):
        klen = int(round(frac * Sk))
        qi = np.arange(Sq)[:, None]
        kj = np.arange(Sk)[None, :]
        vis = np.broadcast_to((kj < klen) & ((kj <= qi + Sk - Sq) if causal
                                             else True), (Sq, Sk))
        seen = np.zeros((Sq, Sk), dtype=int)
        for q0, tiles in walk(Sq, Sk, klen, causal, key_tile):
            for w in range(BQ // WARP_ROWS):
                r0 = q0 + WARP_ROWS * w
                rows = slice(min(r0, Sq), min(r0 + WARP_ROWS, Sq))
                for k0, live, masked in tiles:
                    for j in range(live[w]):
                        keys = slice(min(k0 + NT * j, Sk),
                                     min(k0 + NT * (j + 1), Sk))
                        seen[rows, keys] += 1
                        if not masked[w][j]:
                            assert vis[rows, keys].all(), (Sq, Sk, klen)
        assert (seen <= 1).all() and (seen[vis] == 1).all(), (Sq, Sk, klen)


@pytest.mark.parametrize("name", ["causal_train_256", "noncausal_train_256",
                                  "causal_d128_130_zero_len"])
def test_port_forward_matches_interpret(name):
    """The port's fp32 forward on the CPU (the wrapper's plain version,
    which the card's parity phase holds the kernel to) against the JAX
    kernel in interpret mode, under the same gate, with and without
    lse."""
    B, Sq, Sk, D, causal, lens = FWD_CASES[name]
    x = inputs(200 + sorted(FWD_CASES).index(name), B, Sq, Sk, D)
    scale = D ** -0.5
    jout, jlse = jflash._pallas_flash(*(jnp.asarray(a) for a in x),
                                      jnp.asarray(lens, jnp.float32), causal,
                                      scale, interpret=True, need_lse=True)
    jlse = np.array(jlse).reshape(B, H, -1)[:, :, :Sq]
    q, k, v = (torch.from_numpy(a) for a in x)
    kl = torch.tensor(lens, dtype=torch.int32)
    out, lse = tflash.flash_attention_fwd(q, k, v, causal, scale, kl)
    assert gate(out, np.asarray(jout))[2]
    assert _lse_gate(lse, jlse)[2]
    out2, none = tflash.flash_attention_fwd(q, k, v, causal, scale, kl,
                                            need_lse=False)
    assert none is None and gate(out2, np.asarray(jout))[2]
