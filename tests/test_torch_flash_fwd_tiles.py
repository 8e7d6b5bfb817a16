"""The arithmetic of the bf16 flash forward kernel's tile walk, on the CPU.

``paddle_tpu_torch/kernels/csrc/flash_fwd.cu`` computes the bf16 forward
on the tensor cores: one block per 64-query tile, four warps of 16 rows,
walking the keys below ``min(klen, q0 + 64 + Sk - Sq)`` (causal) or
``klen`` in 128-key tiles from key 0.  For each tile a warp forms S over
the tile's 16-key chunks that hold a key one of its rows sees (the others
are fully masked for it), masks S, takes the row max over the whole tile
and only then updates m, l and the accumulator: m moves once per 128
keys, as the TPU kernel's does with its ``min(128, Sk)`` key block
(``paddle_tpu/kernels/flash_attention.py:343``, ``:353-354``).  P =
exp(S - m) is rounded to bf16 as it is packed per 16-key chunk into the
PV product's A fragment (``:173``), l sums the unrounded P (``:172``),
and the output rounds once, at the store (``:181``).

``tile_model`` below is a plain model of exactly that walk, written here
and nowhere else.  It is held against the port's
``flash_attention_fwd_bf16_reference`` and the port's CPU forward, and
against the JAX Pallas forward in interpret mode, on the bf16 cases of
test_torch_amp.py plus head_dim 128, S 130 and 300 (off both tiles),
causal Sk > Sq and Sq > Sk, and a klen = 0 row, under that file's gate:
within 2^-7 * max |reference| and at most 1% of the elements not
bit-equal; lse within 1e-5 relative.  Only fp32 summation order moves
between the model and either reference; the rounding points do not.

Three planted variants must FAIL the gate: the running max moved per
64-key tile (the port's fault before the repair), l summed over the
bf16-rounded P, and the causal walk's end computed without the Sk - Sq
offset (it drops visible keys when Sk > Sq).  The model without
rounding, on fp32 inputs, matches the fp32 plain version within
1e-5 * max(1, max |plain|).
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

BQ = 64          # query rows a block
WARP_ROWS = 16   # query rows a warp
KEY_TILE = 128   # keys a softmax tile: the TPU kernel's key block
CHUNK = 16       # keys a PV k-step (an m16n8k16 A fragment of P)
NEG_INF = tflash.NEG_INF
BF16_ULP = 2.0 ** -7
MISMATCH_SHARE = 0.01
LSE_RTOL = 1e-5
FP32_TOL = 1e-5
H = 2

# (B, Sq, Sk, D, causal, k_lengths): test_torch_amp.py's FLASH_CASES (head
# dim 64), then S 130 and 300 off both tiles at head dim 128 and 64 with a
# klen = 0 row, cached keys (Sk > Sq) across two and three key tiles, and
# more queries than keys
CASES = {
    "causal_160": (1, 160, 160, 64, True, [160]),
    "noncausal_ragged_96": (1, 96, 96, 64, False, [50]),
    "causal_cached_keys_64x150": (1, 64, 150, 64, True, [120]),
    "masked_row_64": (2, 64, 64, 64, False, [64, 0]),
    "causal_d128_130_zero_len": (2, 130, 130, 128, True, [0, 130]),
    "noncausal_d128_300_ragged": (2, 300, 300, 128, False, [300, 201]),
    "causal_300": (1, 300, 300, 64, True, [300]),
    "causal_cached_keys_20x300": (2, 20, 300, 64, True, [300, 150]),
    "causal_more_queries_130x70": (1, 130, 70, 64, True, [70]),
}
# the cases where some row sees keys on both sides of key 64, many enough
# that a max moved per 64 keys changes over 1% of the outputs
TILE_64_CASES = ("causal_160", "causal_cached_keys_64x150",
                 "causal_d128_130_zero_len", "noncausal_d128_300_ragged",
                 "causal_300", "causal_cached_keys_20x300")
# the cases where a walk without the Sk - Sq offset drops visible keys
OFFSET_CASES = ("causal_cached_keys_64x150", "causal_cached_keys_20x300")


def walk(Sq, Sk, klen, causal, *, key_tile=KEY_TILE, no_offset=False):
    """The kernel's walk for one batch row: ``[(q0, [(k0, [live chunks of
    each warp]), ...]), ...]``.  A warp's chunks past its last visible key
    ``min(klen, q0 + 16 (w + 1) + Sk - Sq)`` are fully masked for its rows
    and skipped.  ``no_offset`` is the planted fault: the ends without
    Sk - Sq."""
    klen = max(0, min(Sk, klen))
    offset = 0 if no_offset else Sk - Sq
    blocks = []
    for q0 in range(0, Sq, BQ):
        k_end = min(klen, q0 + BQ + offset) if causal else klen
        w_end = [min(klen, q0 + WARP_ROWS * (w + 1) + offset) if causal
                 else klen for w in range(BQ // WARP_ROWS)]
        tiles = [(k0, [min(key_tile // CHUNK, max(0, -(-(e - k0) // CHUNK)))
                       for e in w_end])
                 for k0 in range(0, max(k_end, 0), key_tile)]
        blocks.append((q0, tiles))
    return blocks


def tile_model(q, k, v, causal, scale, k_lengths, *, rounding=True,
               key_tile=KEY_TILE, l_from_rounded=False, no_offset=False):
    """(out, lse) of the bf16 forward kernel, warp by warp and tile by
    tile: q/k/v [B, H, S, D].  ``rounding`` False keeps every value fp32
    (the fp32 arithmetic); the planted faults: ``key_tile`` 64 moves the
    max per 64 keys, ``l_from_rounded`` sums the bf16-rounded P into l,
    ``no_offset`` ends the walks without Sk - Sq."""
    B, _, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf = (x.float() for x in (q, k, v))

    def rnd(x):
        return x.to(torch.bfloat16).float() if rounding else x

    out = torch.zeros(B, H, Sq, D)
    lse = torch.full((B, H, Sq), -NEG_INF)
    for b in range(B):
        klen = max(0, min(Sk, int(k_lengths[b])))
        for q0, tiles in walk(Sq, Sk, klen, causal, key_tile=key_tile,
                              no_offset=no_offset):
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
                for k0, live in tiles:
                    if live[w] == 0:  # m, l and acc stay: corr = 1, p = 0
                        continue
                    ke = min(Sk, k0 + CHUNK * live[w])
                    s = torch.matmul(qf[b, :, rows],
                                     kf[b, :, k0:ke].transpose(-1, -2))
                    kj = torch.arange(k0, ke)[None, :]
                    ok = kj < klen
                    if causal:  # the mask keeps the true offset always
                        ok = ok & (kj <= qi + Sk - Sq)
                    s = torch.where(ok, s * scale, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    corr = torch.exp(m - m_new)
                    pr = rnd(p)
                    l = corr * l + (pr if l_from_rounded else p).sum(
                        -1, keepdim=True)
                    acc = acc * corr + torch.matmul(pr, vf[b, :, k0:ke])
                    m = m_new
                denom = l.clamp_min(1e-30)
                out[b, :, rows] = acc / denom
                lse[b, :, rows] = torch.where(
                    l > 0, m + torch.log(denom),
                    torch.tensor(-NEG_INF)).squeeze(-1)
    return (out.to(torch.bfloat16) if rounding else out), lse


def _gate(got, want):
    """(max abs err, bound, share not bit-equal, ok): the bf16 gate."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    bound = BF16_ULP * float(np.abs(want).max())
    share = float(np.mean(got != want))
    return err, bound, share, err <= bound and share <= MISMATCH_SHARE


def _lse_ok(got, want):
    """Fully masked rows exactly +1e30, the others within LSE_RTOL."""
    got, want = got.numpy(), np.asarray(want, np.float32)
    dead = want >= 1e29
    if not (got[dead] == -NEG_INF).all():
        return False
    return bool((np.abs(got - want)[~dead]
                 <= LSE_RTOL * np.abs(want)[~dead]).all())


def _inputs(seed, B, Sq, Sk, D):
    """q, k, v as float32 numpy arrays holding bf16 values."""
    rng = np.random.RandomState(seed)
    out = []
    for S in (Sq, Sk, Sk):
        x = rng.standard_normal((B, H, S, D)).astype(np.float32)
        out.append(torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One case through the JAX Pallas forward in interpret mode, beside
    the port's plain version on the same bf16 inputs."""
    B, Sq, Sk, D, causal, lens = CASES[request.param]
    x = _inputs(sorted(CASES).index(request.param), B, Sq, Sk, D)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in x)
    scale = D ** -0.5
    out, lse = jflash._pallas_flash(jq, jk, jv, jnp.asarray(lens, jnp.float32),
                                    causal, scale, interpret=True,
                                    need_lse=True)
    assert out.dtype == jnp.bfloat16
    lse = np.array(lse).reshape(B, H, -1)[:, :, :Sq].copy()
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    kl = torch.tensor(lens, dtype=torch.int32)
    plain = tflash.flash_attention_fwd_bf16_reference(q, k, v, causal, scale,
                                                      kl)
    return dict(name=request.param, args=(q, k, v, causal, scale, kl),
                lens=lens, plain=plain, jax=(np.asarray(out, np.float32), lse))


def test_tile_model_matches_plain_and_interpret(case):
    out, lse = tile_model(*case["args"])
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    port = tflash.flash_attention_fwd(*case["args"])
    for ref_out, ref_lse in (case["plain"], port, case["jax"]):
        if isinstance(ref_out, torch.Tensor):
            ref_out = ref_out.float().numpy()
        err, bound, share, ok = _gate(out, ref_out)
        assert ok, (err, bound, share)
        assert _lse_ok(lse, ref_lse)
    for b, n in enumerate(case["lens"]):
        if n == 0:  # a fully masked row: zeros, lse = +1e30
            assert bool((out[b] == 0).all())
            assert bool((lse[b] == -NEG_INF).all())


def test_port_forward_matches_interpret(case):
    """The port's bf16 forward on the CPU (the wrapper's plain version,
    which the card's parity phase holds the kernel to) against the JAX
    kernel, under the same gate."""
    out, lse = tflash.flash_attention_fwd(*case["args"])
    err, bound, share, ok = _gate(out, case["jax"][0])
    assert ok, (err, bound, share)
    assert _lse_ok(lse, case["jax"][1])


def test_max_per_64_keys_fails_the_gate(case):
    """The running max moved once per 64 keys: P rounds against another
    max wherever a row sees keys on both sides of key 64.  The gate must
    refuse it there; where no row sees a key past 63 it is the same
    walk."""
    out, lse = tile_model(*case["args"], key_tile=64)
    err, bound, share, ok = _gate(out, case["jax"][0])
    if case["name"] in TILE_64_CASES:
        assert not ok, (err, bound, share)
    B, Sq, Sk, D, causal, lens = CASES[case["name"]]
    if max(lens) <= 64:
        assert torch.equal(out, tile_model(*case["args"])[0])


def test_l_from_the_rounded_p_fails_the_gate(case):
    """l summed over bf16(P) instead of the unrounded P: a moved rounding
    point, which the gate must refuse on every case."""
    out, _ = tile_model(*case["args"], l_from_rounded=True)
    err, bound, share, ok = _gate(out, case["jax"][0])
    assert not ok, (err, bound, share)


def test_walk_without_the_causal_offset_fails_the_gate(case):
    """The walk's ends without Sk - Sq: with cached keys, visible keys are
    dropped and the gate must refuse the output; otherwise the walk only
    visits masked keys more or fewer, which changes nothing."""
    out, _ = tile_model(*case["args"], no_offset=True)
    err, bound, share, ok = _gate(out, case["jax"][0])
    if case["name"] in OFFSET_CASES:
        assert not ok, (err, bound, share)
    else:
        assert torch.equal(out, tile_model(*case["args"])[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_unrounded_model_matches_the_fp32_plain_version(name):
    B, Sq, Sk, D, causal, lens = CASES[name]
    q, k, v = (torch.from_numpy(a) * 1.5 for a in _inputs(
        100 + sorted(CASES).index(name), B, Sq, Sk, D))
    kl = torch.tensor(lens, dtype=torch.int32)
    scale = D ** -0.5
    want, want_lse = tflash.flash_attention_fwd_reference(q, k, v, causal,
                                                          scale, kl)
    got, lse = tile_model(q, k, v, causal, scale, kl, rounding=False)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= FP32_TOL * max(
        1.0, float(want.abs().max()))
    assert _lse_ok(lse, want_lse)


SHAPES = [(Sq, Sk) for Sq in (1, 20, 64, 65, 130, 256)
          for Sk in (1, 37, 64, 129, 150, 300)]


@pytest.mark.parametrize("causal", [True, False])
def test_walk_covers_every_visible_key(causal):
    """Index arithmetic alone, over query and key lengths on and off both
    tiles and every klen class: each visible (query, key) pair lies in a
    live chunk of its warp's walk, exactly once; with cached keys the
    walk without the offset misses one."""
    missed_without_offset = 0
    for (Sq, Sk), frac in itertools.product(SHAPES, (0.0, 0.3, 1.0)):
        klen = int(round(frac * Sk))
        qi = np.arange(Sq)[:, None]
        kj = np.arange(Sk)[None, :]
        vis = np.broadcast_to((kj < klen) & ((kj <= qi + Sk - Sq) if causal
                                             else True), (Sq, Sk))

        def covered(blocks):
            seen = np.zeros((Sq, Sk), dtype=int)
            for q0, tiles in blocks:
                for w in range(BQ // WARP_ROWS):
                    r0 = q0 + WARP_ROWS * w
                    for k0, live in tiles:
                        seen[r0:r0 + WARP_ROWS,
                             k0:min(Sk, k0 + CHUNK * live[w])] += 1
            return seen

        seen = covered(walk(Sq, Sk, klen, causal))
        assert (seen <= 1).all() and (seen[vis] == 1).all(), (Sq, Sk, klen)
        if not (covered(walk(Sq, Sk, klen, causal, no_offset=True))[vis]
                == 1).all():
            assert causal and Sk > Sq
            missed_without_offset += 1
    assert (missed_without_offset > 0) == causal
