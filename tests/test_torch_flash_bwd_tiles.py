"""The arithmetic of the bf16 flash backward kernels' tile walks, on the CPU.

``paddle_tpu_torch/kernels/csrc/flash_bwd.cu`` computes the bf16 backward
on the tensor cores in two kernels, each output owned by one block:

- dq: one block per 64-query tile walks the 64-key tiles below
  ``min(klen, q0 + 64 + Sk - Sq)`` (causal) or ``klen``, and adds
  bf16(dS) K for each;
- dkv: one block per 64-key tile walks the 64-query tiles from
  ``max(0, k0 - (Sk - Sq))`` rounded down to a tile (causal) or 0 up to
  Sq, when the tile holds a key below klen, and adds bf16(P^T) dO to dV
  and bf16(dS^T) Q to dK.

Operands are bf16, sums fp32 (mma.sync's exact products); P is
exp(scale * S - lse) on visible entries and exactly 0 elsewhere, dS =
P * (dP - D) * scale from the unrounded P, and each gradient rounds once
at its store: the TPU kernels' rounding points
(``paddle_tpu/kernels/flash_attention.py:227``, ``:267``, ``:270``,
``:232``, ``:275-276``).

``tile_model`` below is a plain model of exactly those walks, written
here and nowhere else.  It is held against the port's
``flash_attention_bwd_reference`` and against the JAX Pallas dq / dkv
kernels in interpret mode on the bf16 cases of test_torch_amp.py plus
head_dim 128, S 130 off the tile, causal Sk > Sq and Sq > Sk, and a
klen = 0 row, under that file's gate: within 2^-7 * max |reference| and
at most 1% of the elements not bit-equal.  Only fp32 summation order
moves between the model and either reference; the rounding points do
not.

Two planted faults must FAIL the gate: dS built from the bf16-rounded P
(a rounding point moved, the shortcut the packed P^T fragment invites
in dkv), and the causal walk bounds computed without the Sk - Sq offset
(dq's frontier, dkv's first query tile), which drops visible tiles when
Sk > Sq.  The model without rounding, on fp32 inputs, matches the fp32
plain version within 1e-5 * max(1, max |plain|).
"""

import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402

TILE = 64
BF16_ULP = 2.0 ** -7
MISMATCH_SHARE = 0.01
FP32_TOL = 1e-5
H = 2

# (B, Sq, Sk, D, causal, k_lengths): test_torch_amp.py's FLASH_CASES (head
# dim 64), then head dim 128 with S 130 off the tile and a klen = 0 row,
# cached keys (Sk > Sq) across three key tiles, more queries than keys
CASES = {
    "causal_160": (1, 160, 160, 64, True, [160]),
    "noncausal_ragged_96": (1, 96, 96, 64, False, [50]),
    "causal_cached_keys_64x150": (1, 64, 150, 64, True, [120]),
    "masked_row_64": (2, 64, 64, 64, False, [64, 0]),
    "causal_d128_130_zero_len": (2, 130, 130, 128, True, [0, 77]),
    "causal_cached_keys_20x150": (2, 20, 150, 64, True, [150, 61]),
    "causal_more_queries_130x70": (1, 130, 70, 64, True, [70]),
}
# the cases where a walk without the Sk - Sq offset drops a visible tile
OFFSET_CASES = ("causal_cached_keys_64x150", "causal_cached_keys_20x150")


def walk_tiles(Sq, Sk, klen, causal, no_offset=False):
    """The (query tile, key tile) origins each kernel visits for one batch
    row: (dq's, dkv's).  ``no_offset`` is the planted fault: the causal
    bounds without Sk - Sq."""
    klen = max(0, min(Sk, klen))
    offset = 0 if no_offset else Sk - Sq
    dq = []
    for q0 in range(0, Sq, TILE):
        k_end = min(klen, q0 + TILE + offset) if causal else klen
        dq += [(q0, k0) for k0 in range(0, max(k_end, 0), TILE)]
    dkv = []
    for k0 in range(0, Sk, TILE):
        q_begin = max(0, k0 - offset) // TILE * TILE if causal else 0
        q_end = Sq if k0 < klen else 0
        dkv += [(q0, k0) for q0 in range(q_begin, q_end, TILE)]
    return dq, dkv


def tile_model(q, k, v, dout, lse, dvec, k_lengths, causal, scale, *,
               rounding=True, round_p_first=False, no_offset=False):
    """(dQ, dK, dV) of the two bf16 kernels, tile by tile: q/k/v/dout
    [B, H, S, D], lse and dvec [B, H, Sq] fp32.  ``rounding`` False keeps
    every value fp32 (the fp32 arithmetic); ``round_p_first`` builds dS
    from the bf16-rounded P; ``no_offset`` walks without Sk - Sq."""
    B, _, Sq, D = q.shape
    Sk = k.shape[2]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))

    def rnd(x):
        return x.to(torch.bfloat16).float() if rounding else x

    dq = torch.zeros(B, H, Sq, D)
    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    for b in range(B):
        klen = max(0, min(Sk, int(k_lengths[b])))

        def tile(q0, k0):
            qs, ks = slice(q0, q0 + TILE), slice(k0, k0 + TILE)
            s = torch.matmul(qf[b, :, qs], kf[b, :, ks].transpose(-1, -2))
            qi = torch.arange(q0, min(q0 + TILE, Sq))[:, None]
            kj = torch.arange(k0, min(k0 + TILE, Sk))[None, :]
            ok = kj < klen
            if causal:  # the mask keeps the true offset in every variant
                ok = ok & (kj <= qi + Sk - Sq)
            p = torch.where(ok, torch.exp(s * scale - lse[b, :, qs, None]),
                            torch.zeros(()))
            dp = torch.matmul(dof[b, :, qs], vf[b, :, ks].transpose(-1, -2))
            pd = rnd(p) if round_p_first else p
            ds = pd * (dp - dvec[b, :, qs, None]) * scale
            return qs, ks, p, ds

        dq_walk, dkv_walk = walk_tiles(Sq, Sk, klen, causal, no_offset)
        for q0, k0 in dq_walk:
            qs, ks, _, ds = tile(q0, k0)
            dq[b, :, qs] += torch.matmul(rnd(ds), kf[b, :, ks])
        for q0, k0 in dkv_walk:
            qs, ks, p, ds = tile(q0, k0)
            dv[b, :, ks] += torch.matmul(rnd(p).transpose(-1, -2),
                                         dof[b, :, qs])
            dk[b, :, ks] += torch.matmul(rnd(ds).transpose(-1, -2),
                                         qf[b, :, qs])
    if rounding:
        return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))
    return dq, dk, dv


def _gate(got, want):
    """(max abs err, bound, share not bit-equal, ok): the bf16 gate."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    bound = BF16_ULP * float(np.abs(want).max())
    share = float(np.mean(got != want))
    return err, bound, share, err <= bound and share <= MISMATCH_SHARE


def _inputs(seed, B, Sq, Sk, D):
    """q, k, v, dout as float32 numpy arrays holding bf16 values."""
    rng = np.random.RandomState(seed)
    out = []
    for S in (Sq, Sk, Sk, Sq):
        x = rng.standard_normal((B, H, S, D)).astype(np.float32)
        out.append(torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One case through the JAX Pallas kernels in interpret mode: the
    forward's out and lse, and the dq / dkv kernels' gradients."""
    B, Sq, Sk, D, causal, lens = CASES[request.param]
    x = _inputs(sorted(CASES).index(request.param), B, Sq, Sk, D)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16) for a in x)
    scale = D ** -0.5
    out, lse = jflash._pallas_flash(jq, jk, jv, jnp.asarray(lens, jnp.float32),
                                    causal, scale, interpret=True,
                                    need_lse=True)
    lse = np.array(lse).reshape(B, H, -1)[:, :, :Sq].copy()
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, scale=scale, k_lengths=np.asarray(lens),
        force="interpret"), jq, jk, jv)
    grads = vjp(jdo)
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in x)
    out = torch.from_numpy(np.asarray(out, np.float32)).to(torch.bfloat16)
    lse = torch.from_numpy(lse)
    dvec = (do.float() * out.float()).sum(-1)
    kl = torch.tensor(lens, dtype=torch.int32)
    plain = tflash.flash_attention_bwd_reference(q, k, v, kl, out, lse, do,
                                                 causal, scale)
    return dict(name=request.param, args=(q, k, v, do, lse, dvec, kl, causal,
                                          scale),
                lens=lens, Sk=Sk, plain=plain,
                jax=[np.asarray(g, np.float32) for g in grads])


def test_tile_model_matches_plain_and_interpret(case):
    got = tile_model(*case["args"])
    for name, g, plain, want in zip(("dq", "dk", "dv"), got, case["plain"],
                                    case["jax"]):
        assert g.dtype == torch.bfloat16
        for ref in (plain.float().numpy(), want):
            err, bound, share, ok = _gate(g, ref)
            assert ok, (name, err, bound, share)
    dq, dk, dv = got
    for b, n in enumerate(case["lens"]):
        if n == 0:  # a fully masked row: dQ = 0 exactly
            assert bool((dq[b] == 0).all())
        # key rows at or past klen: dK = dV = 0 exactly
        assert bool((dk[b, :, n:] == 0).all()) and bool(
            (dv[b, :, n:] == 0).all())


def test_dS_from_the_rounded_P_fails_the_gate(case):
    """The shortcut the packed P^T fragment invites in dkv: dS from
    bf16(P).  It moves a rounding point, and the gate must refuse dK and
    dQ against both references, while dV (no dS) still passes."""
    dq, dk, dv = tile_model(*case["args"], round_p_first=True)
    for name, g, plain, want in zip(("dq", "dk"), (dq, dk), case["plain"],
                                    case["jax"]):
        for ref in (plain.float().numpy(), want):
            err, bound, share, ok = _gate(g, ref)
            assert not ok, (name, err, bound, share)
    assert _gate(dv, case["jax"][2])[3]


def test_walk_without_the_causal_offset_fails_the_gate(case):
    """dq's frontier q0 + 64 and dkv's first tile k0 without Sk - Sq: with
    cached keys whole visible tiles are skipped and the gate must refuse
    dQ and dK/dV; without cached keys the walk is the same."""
    got = tile_model(*case["args"], no_offset=True)
    verdicts = [_gate(g, want)[3] for g, want in zip(got, case["jax"])]
    if case["name"] in OFFSET_CASES:
        assert verdicts == [False] * 3, verdicts
    else:
        assert verdicts == [True] * 3, verdicts


@pytest.mark.parametrize("name", sorted(CASES))
def test_unrounded_model_matches_the_fp32_plain_version(name):
    B, Sq, Sk, D, causal, lens = CASES[name]
    q, k, v, do = (torch.from_numpy(a) * 1.5 for a in _inputs(
        100 + sorted(CASES).index(name), B, Sq, Sk, D))
    kl = torch.tensor(lens, dtype=torch.int32)
    scale = D ** -0.5
    out, lse = tflash.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                    kl)
    dvec = (do * out).sum(-1)
    want = tflash.flash_attention_bwd_reference(q, k, v, kl, out, lse, do,
                                                causal, scale)
    got = tile_model(q, k, v, do, lse, dvec, kl, causal, scale,
                     rounding=False)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        bound = FP32_TOL * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound


SHAPES = [(Sq, Sk) for Sq in (1, 20, 64, 65, 130, 256)
          for Sk in (1, 37, 64, 150, 256)]


@pytest.mark.parametrize("causal", [True, False])
def test_walks_visit_every_visible_tile(causal):
    """Index arithmetic alone, over query and key lengths on and off the
    tile and every klen class: each (query tile, key tile) pair holding a
    visible entry is walked once by each kernel; with cached keys the
    walk without the offset misses one."""
    missed_without_offset = 0
    for (Sq, Sk), frac in itertools.product(SHAPES, (0.0, 0.3, 1.0)):
        klen = int(round(frac * Sk))
        qi = np.arange(Sq)[:, None]
        kj = np.arange(Sk)[None, :]
        vis = kj < klen
        if causal:
            vis = vis & (kj <= qi + Sk - Sq)
        need = {(i // TILE * TILE, j // TILE * TILE)
                for i, j in zip(*np.nonzero(vis))}
        dq, dkv = walk_tiles(Sq, Sk, klen, causal)
        for walk in (dq, dkv):
            assert len(walk) == len(set(walk))
            assert need <= set(walk), (Sq, Sk, klen)
        dq_n, dkv_n = walk_tiles(Sq, Sk, klen, causal, no_offset=True)
        if not (need <= set(dq_n) and need <= set(dkv_n)):
            assert causal and Sk > Sq
            missed_without_offset += 1
    assert (missed_without_offset > 0) == causal
