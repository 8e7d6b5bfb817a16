"""bf16 KV pools on the port (paddle_tpu_torch: KVCachePool(dtype=
"bfloat16"), paged_bf16_reference, the bf16 variants of
paged_decode_attention, and the serving loop over a bf16 pool with a
prefix cache) against the JAX package, on the CPU.  The same numpy inputs
and the same init_decode_params seed go to both packages.

The reference is the JAX Pallas kernel itself in interpret mode: on a
CPU the JAX package's ``auto`` arm takes its reference gather, which
computes bf16 pages in fp32 with no rounding of q, p or the output and so
differs from the kernel (by 4.7e-3 in the logits of this file's 2-layer
loop, where the port lies within 1e-5 of the kernel: the loop test
asserts the first distance exceeds the port's tolerance); the port
follows the kernel.

Tolerances:
- the bf16 plain version against the interpret kernel: within 2^-7 *
  max |kernel| and at most 1% of the elements not bit-equal, over the
  rows a step reads.  Both round at the same five points (q to bf16, the
  running max once per page, p to bf16 for the PV product only, l from
  the unrounded p, the output to bf16), so an output differs only where
  fp32 summation order or an exp ulp moves a value across a bf16
  rounding boundary (0-0.02% here); each of the three planted faults,
  one moved rounding point each, changes 2-50% of the elements and must
  fail the gate;
- bf16 pool pages: EQUAL (both round to nearest even from the same fp32
  rows);
- the loop's logits: 1e-3 absolute.  The port lies within 1e-5 of the
  interpret kernel here, while the JAX package's own reference arm,
  which leaves out the rounding points, lies 4.7e-3 from it;
- tokens and counters: identical.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")
jprefix = importlib.import_module("paddle_tpu.serving.prefixcache")
jspec = importlib.import_module("paddle_tpu.serving.speculative")

from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving import prefixcache as tprefix  # noqa: E402

BF16_ULP = 2.0 ** -7
MISMATCH_SHARE = 0.01
LOGIT_ATOL = 1e-3
# the JAX parity matrix's config (tests/test_speculative.py)
CFG = dict(vocab_size=61, d_model=32, n_head=8, n_layer=2, d_inner=48,
           max_length=48)


def _gate(got, want, rows):
    """(max abs err, bound, share of elements not bit-equal) over the
    valid rows, and whether the bf16 gate holds."""
    m = np.broadcast_to(rows, got.shape)
    g, w = got[m], want[m]
    err = float(np.abs(g - w).max())
    bound = BF16_ULP * float(np.abs(w).max())
    share = float((g != w).mean())
    return err, bound, share, err <= bound and share <= MISMATCH_SHARE


def _bf16(x):
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.float32))
                            ).to(torch.bfloat16)


def _filled_pools(ps, Hq, Hkv, D, lengths, rng, window=None, sinks=None):
    """A JAX and a port bf16 pool (one layer) filled with the same fp32
    rows in two rounds; with windows, each windowed row is evicted before
    its last 3 tokens, as the loop evicts before a step's appends."""
    pages = sum(-(-n // ps) for n in lengths) + 4
    kw = dict(num_pages=pages, page_size=ps, num_layers=1, num_heads=Hq,
              head_dim=D, num_kv_heads=Hkv, dtype="bfloat16")
    jp, tp = jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)
    ids = list(range(len(lengths)))
    for s in ids:
        jp.allocate(s)
        tp.allocate(s)

    def fill(counts):
        jpg, jsl = jp.append_tokens(ids, counts)
        tpg, tsl = tp.append_tokens(ids, counts)
        assert np.array_equal(jpg, tpg) and np.array_equal(jsl, tsl)
        k = rng.standard_normal((len(jpg), Hkv, D)).astype(np.float32)
        v = rng.standard_normal((len(jpg), Hkv, D)).astype(np.float32)
        jp.write_kv(0, jpg, jsl, jnp.asarray(k), jnp.asarray(v))
        tp.write_kv(0, tpg, tsl, torch.from_numpy(k), torch.from_numpy(v))

    fill([n - 3 for n in lengths])
    if window is not None:
        for s, w, k in zip(ids, window, sinks):
            if w < tpaged.PAD_START:
                assert jp.evict_interior(s, w, k) == tp.evict_interior(s, w,
                                                                       k)
    fill([3] * len(lengths))
    return jp, tp, ids


LENS = [37, 5, 22, 14]
QLENS = np.array([3, 1, 3, 2], np.int32)
WINDOWS = np.array([8, tpaged.PAD_START, 1, 6], np.int32)
SINKS = np.array([4, 0, 0, 2], np.int32)
CASES = [(walk, G, ps) for walk in ("decode", "verify", "starts_window",
                                    "two_level")
         for G in (1, 2) for ps in (4, 16)]


@pytest.mark.parametrize("walk,G,ps", CASES)
def test_bf16_plain_version_matches_the_interpret_kernel(walk, G, ps):
    rng = np.random.RandomState(G * 100 + ps)
    Hkv, D = 2, 16
    Hq = G * Hkv
    windowed = walk in ("starts_window", "two_level")
    jp, tp, ids = _filled_pools(ps, Hq, Hkv, D, LENS, rng,
                                *((WINDOWS, SINKS) if windowed else ()))
    sq = 1 if walk in ("decode", "two_level") else 3
    q = rng.standard_normal((len(LENS), Hq, sq, D)).astype(np.float32)
    ql = QLENS if sq > 1 else None
    jkw, tkw = {}, {}
    if walk == "two_level":
        jt, jl = jp.two_level_tables(ids, 2)
        tt, tl = tp.two_level_tables(ids, 2)
    elif walk == "starts_window":
        jt, st, jl = jp.page_tables_with_starts(ids)
        tt, tst, tl = tp.page_tables_with_starts(ids)
        assert np.array_equal(st, tst)
        jkw["page_starts"], tkw["page_starts"] = jnp.asarray(st), tst
    else:
        jt, jl = jp.page_table_batch(ids)
        tt, tl = tp.page_table_batch(ids)
    if windowed:
        jkw.update(windows=jnp.asarray(WINDOWS), sinks=jnp.asarray(SINKS))
        tkw.update(windows=WINDOWS, sinks=SINKS)
    want = np.asarray(jpaged.paged_decode_attention(
        jnp.asarray(q), jp.k_pages[0], jp.v_pages[0], jt, jnp.asarray(jl),
        impl="interpret", q_lengths=None if ql is None else jnp.asarray(ql),
        **jkw))
    kp, vp = tp.k_pages[0], tp.v_pages[0]
    assert kp.dtype == torch.bfloat16
    assert torch.equal(kp, _bf16(jp.k_pages[0]))
    rows = (np.ones((len(LENS), 1, 1, 1), bool) if sq == 1 else
            (np.arange(sq)[None, :] < QLENS[:, None])[:, None, :, None])

    def port(fault=None):
        return tpaged.paged_bf16_reference(
            torch.from_numpy(q), kp, vp, tt, tl,
            None if ql is None else torch.from_numpy(ql),
            tkw.get("page_starts"), tkw.get("windows"), tkw.get("sinks"),
            fault=fault).numpy()

    err, bound, share, ok = _gate(port(), want, rows)
    assert ok, (err, bound, share)
    # the wrapper takes the same plain version for a CPU bf16 pool
    got = tpaged.paged_decode_attention(
        torch.from_numpy(q), kp, vp, tt, torch.from_numpy(tl),
        q_lengths=None if ql is None else torch.from_numpy(ql), **tkw)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), port())
    for fault in tpaged.BF16_FAULTS:
        err, bound, share, ok = _gate(port(fault), want, rows)
        assert not ok, (fault, err, bound, share)


def test_bf16_write_kv_is_bit_equal_to_the_jax_pool():
    rng = np.random.RandomState(3)
    kw = dict(num_pages=9, page_size=4, num_layers=2, num_heads=4,
              head_dim=8, num_kv_heads=2, dtype="bfloat16")
    jp, tp = jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)
    assert tp.bytes_per_page() == jp.bytes_per_page() == 2 * 2 * 4 * 2 * 8 * 2
    for s in (0, 1):
        jp.allocate(s)
        tp.allocate(s)
    for counts in ([5, 3], [1, 6]):
        jpg, jsl = jp.append_tokens([0, 1], counts)
        tpg, tsl = tp.append_tokens([0, 1], counts)
        # magnitudes across the exponent range, and values at a rounding tie
        k = (rng.standard_normal((len(jpg), 2, 8))
             * 10.0 ** rng.randint(-3, 4, (len(jpg), 2, 8))).astype(np.float32)
        k[0, 0, 0] = 1.0 + 2.0 ** -8  # halfway: rounds to even (1.0)
        v = rng.standard_normal((len(jpg), 2, 8)).astype(np.float32)
        for layer in (0, 1):
            jp.write_kv(layer, jpg, jsl, jnp.asarray(k), jnp.asarray(v))
            tp.write_kv(layer, tpg, tsl, torch.from_numpy(k),
                        torch.from_numpy(v))
    assert torch.equal(tp.k_pages, _bf16(jp.k_pages))
    assert torch.equal(tp.v_pages, _bf16(jp.v_pages))
    assert float(tp.k_pages[0, 0, tpg[0], tsl[0], 0]) == 1.0


def test_wrapper_refuses_pools_of_other_dtypes():
    q = torch.zeros(1, 2, 1, 8)
    pages = torch.zeros(2, 3, 4, 8, dtype=torch.float16)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32, int8 or bfloat16"):
            tpaged.paged_decode_attention(q, pages.to(dt), pages.to(dt),
                                          np.zeros((1, 1), np.int32),
                                          np.ones(1, np.int32))
    with pytest.raises(ValueError, match="pool dtype"):
        tkv.KVCachePool(4, 4, 1, 2, 8, device="cpu", dtype="float16")


def _shared_prompts(seed=4):
    """Seven prompts, six opening with one 18-token prefix."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, CFG["vocab_size"], size=18).tolist()
    out = [shared + rng.randint(1, CFG["vocab_size"], size=n).tolist()
           for n in (3, 5, 1, 6, 2, 4)]
    out.insert(3, rng.randint(1, CFG["vocab_size"], size=9).tolist())
    return out


COUNTERS = ("steps", "prefill_steps", "decode_steps", "spec_steps",
            "drafted_tokens", "accepted_tokens", "rolled_back_tokens",
            "prefix_hits", "prefix_misses", "cached_prefill_tokens",
            "prefill_tokens", "max_prefill_tokens_step")


@pytest.mark.parametrize("d", [0, 2])
def test_bf16_loop_with_prefix_cache_matches_the_jax_kernel_loop(d):
    kw = dict(CFG, n_kv_head=4)
    jcfg, tcfg = jgen.DecodeConfig(**kw), tgen.DecodeConfig(**kw)
    params = jgen.init_decode_params(jcfg, seed=4)
    pkw = dict(num_pages=40, page_size=4, num_layers=2, num_heads=8,
               head_dim=4, num_kv_heads=4, dtype="bfloat16")
    jpool, tpool = jkv.KVCachePool(**pkw), tkv.KVCachePool(device="cpu",
                                                           **pkw)
    jcache, tcache = jprefix.PrefixCache(jpool), tprefix.PrefixCache(tpool)
    loop_kw = dict(max_batch=2, prefill_chunk=8, speculate=d)
    # own-history drafters on both sides (the JAX default also drafts from
    # the cache's corpus, which the port leaves for later)
    jloop = jgen.ContinuousBatchingLoop(
        params, jcfg, jpool, paged_impl="interpret", prefix_cache=jcache,
        drafter=jspec.PromptLookupDrafter(max_draft=d) if d else None,
        **loop_kw)
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tpool, device="cpu",
                                        prefix_cache=tcache, **loop_kw)
    prompts = _shared_prompts()
    jres = jloop.run([jgen.DecodeRequest(p, 6) for p in prompts])
    tres = tloop.run([tgen.DecodeRequest(p, 6) for p in prompts])
    for jr, tr in zip(jres, tres):
        assert tr.error is None and tr.tokens == jr.tokens
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)
    for key in COUNTERS:
        assert getattr(tloop, key) == getattr(jloop, key), key
    assert tloop.prefix_hits > 0 and tloop.max_prefill_tokens_step <= 8
    for key in ("cow_copies", "shared_attach_pages", "page_allocs",
                "page_frees"):
        assert tpool.stats()[key] == jpool.stats()[key], key
    assert tpool.stats()["cow_copies"] > 0
    assert tpool.check_invariants()["ok"]
    tcache.clear()
    assert tpool.used_pages == 0 and tpool.check_invariants()["ok"]
    if d == 0:
        # the JAX package's CPU default arm on the same traffic computes
        # bf16 pages unrounded: it lies farther from its own kernel than
        # the port does, which is why these tests read the kernel
        rpool = jkv.KVCachePool(**pkw)
        rres = jgen.ContinuousBatchingLoop(
            params, jcfg, rpool, paged_impl="reference",
            prefix_cache=jprefix.PrefixCache(rpool), **loop_kw).run(
                [jgen.DecodeRequest(p, 6) for p in prompts])
        far = max(float(np.abs(a - b).max()) for rr, jr in zip(rres, jres)
                  for a, b in zip(rr.logits, jr.logits))
        assert far > LOGIT_ATOL
