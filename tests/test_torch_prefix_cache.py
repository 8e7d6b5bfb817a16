"""The port's shared-prefix serving (paddle_tpu_torch: refcounted
KVCachePool pages with copy-on-write, serving/prefixcache.py,
serving/prefill_sched.py, TransformerDecoder.chunk_prefill_step and the
loop's prefix_cache= / prefill_chunk=) against the JAX package's, on the
CPU.  The same numpy inputs and the same init_decode_params seed go to
both packages.

Tolerances:
- pool and cache state (tables, refcounts, free-list order, stats,
  invariants, trie matches and entries): EQUAL, after every operation;
- page content: EQUAL (fp32 and bf16 rows are copied or rounded the same
  way; int8 pages and scales come from the same float32 arithmetic);
- plan_chunks: EQUAL, on every generated case;
- chunk_prefill_step and loop logits: rtol/atol 1e-4, as the port's
  serving tests hold its steps (a 2-layer post-norm stack in float32
  leaves about 1e-6; a wrong mask, position or page moves logits by
  O(0.1));
- tokens and counters: identical.
"""

import importlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jprefix = importlib.import_module("paddle_tpu.serving.prefixcache")
jsched = importlib.import_module("paddle_tpu.serving.prefill_sched")
jspec = importlib.import_module("paddle_tpu.serving.speculative")

from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving import prefill_sched as tsched  # noqa: E402
from paddle_tpu_torch.serving import prefixcache as tprefix  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = ["float32", "int8", "bfloat16"]
STATS = ("page_allocs", "page_frees", "token_appends",
         "used_pages_high_water", "tokens_truncated", "pages_evicted",
         "cow_copies", "shared_attach_pages", "used_pages", "free_pages",
         "num_pages", "live_sequences")
REPORT = ("ok", "orphaned_pages", "double_owned_pages",
          "refcount_mismatches", "free_list_errors", "length_mismatches",
          "scale_errors", "used_pages", "shared_pages", "live_sequences")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(jp, tp, exact=True):
    """Every piece of pool state, the JAX pool's against the port's; with
    ``exact`` False the page content (model-computed K/V, fp32 ulps apart)
    only within a bf16 ulp or an int8 step."""
    assert {s: (h.pages, h.length, h.starts)
            for s, h in jp._tables.items()} == \
        {s: (h.pages, h.length, h.starts) for s, h in tp._tables.items()}
    assert jp._ref == tp._ref
    assert jp._free == tp._free
    assert jp._allocator == tp._allocator
    assert jp.uncharged_live_pages() == tp.uncharged_live_pages()
    js, ts = jp.stats(), tp.stats()
    assert {k: js[k] for k in STATS} == {k: ts[k] for k in STATS}
    jr, tr = jp.check_invariants(), tp.check_invariants()
    assert {k: jr[k] for k in REPORT} == {k: tr[k] for k in REPORT}
    assert tr["ok"]
    if not exact:
        for a, b, sa, sb in ((jp.k_pages, tp.k_pages, jp.k_scales,
                              tp.k_scales),
                             (jp.v_pages, tp.v_pages, jp.v_scales,
                              tp.v_scales)):
            a, b = _np(a), _np(b)
            if tp.quantized:
                a = a * np.asarray(sa)[:, None, :, None, None]
                b = b * sb.numpy()[:, None, :, None, None]
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0.02)
        return
    assert np.array_equal(_np(jp.k_pages), _np(tp.k_pages))
    assert np.array_equal(_np(jp.v_pages), _np(tp.v_pages))
    if tp.quantized:
        assert np.array_equal(jp.k_scales, tp.k_scales.numpy())
        assert np.array_equal(jp.v_scales, tp.v_scales.numpy())


def _pool_pair(dtype, pages=16, ps=4, layers=2):
    kw = dict(num_pages=pages, page_size=ps, num_layers=layers, num_heads=4,
              head_dim=8, num_kv_heads=2, dtype=dtype)
    return jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)


class _Both:
    """Apply each pool operation to both pools and compare the results and
    the state after it."""

    def __init__(self, dtype, **kw):
        self.jp, self.tp = _pool_pair(dtype, **kw)
        self.rng = np.random.RandomState(7)
        # holds taken outside any table (a cache's), known to the audits
        self.held = {}
        for pool in (self.jp, self.tp):
            pool.register_owner(lambda: dict(self.held))

    def retain(self, pages):
        for p in pages:
            self.held[p] = self.held.get(p, 0) + 1
        self("retain_pages", pages)

    def release(self, pages, scrub=False):
        for p in pages:
            self.held[p] -= 1
            if not self.held[p]:
                del self.held[p]
        return self("release_pages", pages, scrub=scrub)

    def __call__(self, op, *args, **kw):
        jout = getattr(self.jp, op)(*args, **kw)
        tout = getattr(self.tp, op)(*args, **kw)
        if isinstance(jout, tuple):
            for a, b in zip(jout, tout):
                assert np.array_equal(np.asarray(a), np.asarray(b))
        elif op != "allocate":
            assert jout == tout, op
        _same(self.jp, self.tp)
        return tout

    def append(self, seq_ids, counts):
        """append_tokens, then the same random K/V into every layer."""
        pg, sl = self("append_tokens", seq_ids, counts)
        for layer in range(self.tp.num_layers):
            k = self.rng.standard_normal((len(pg), 2, 8)).astype(np.float32)
            v = self.rng.standard_normal((len(pg), 2, 8)).astype(np.float32)
            self.jp.write_kv(layer, pg, sl, jnp.asarray(k), jnp.asarray(v))
            self.tp.write_kv(layer, pg, sl, torch.from_numpy(k),
                             torch.from_numpy(v))
        _same(self.jp, self.tp)
        return pg, sl


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_sharing_operations_match_the_jax_pool(dtype):
    b = _Both(dtype)
    b("allocate", 0)
    b.append([0], [10])  # pages for 0: 3, the tail partly filled
    pages0 = list(b.tp._tables[0].pages)
    b.retain(pages0)  # a cache entry's holds
    b("allocate", 1)
    b("attach_prefix", 1, pages0, 10)  # the shared partial tail
    b("allocate", 2)
    b("attach_prefix", 2, pages0[:2], 8)  # whole pages only
    assert b.tp.refcount(pages0[2]) == 3
    b.append([1, 2, 0], [2, 3, 1])  # 1 and 0 copy the shared tail
    assert b.tp.stats()["cow_copies"] == 2
    b("truncate_seq", 1, 9)  # back into the copied page
    b("truncate_seq", 2, 5)  # drops a shared whole page: a hold only
    b.append([2], [6])
    b("evict_interior", 0, 3, 0)  # drops shared interior pages' holds
    assert b.tp.refcount(pages0[0]) >= 1
    b("scrub_seq_pages", 2)  # only the pages it alone holds
    b("free_seq", 0)
    b.release(pages0[:2])
    b.release([pages0[2]], scrub=True)
    b("free_seq", 1)
    b("free_seq", 2)
    assert b.tp.used_pages == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_exhaustion_calls_the_reclaimer_and_stays_atomic(dtype):
    b = _Both(dtype, pages=6)
    queue = {"j": [], "t": []}

    def reclaimer(key, pool):
        def fn(short):
            freed = 0
            while queue[key] and freed < short:
                p = queue[key].pop()
                if key == "t":
                    del b.held[p]
                freed += pool.release_pages([p])
            return freed
        return fn

    b.jp.register_reclaimer(reclaimer("j", b.jp))
    b.tp.register_reclaimer(reclaimer("t", b.tp))
    b("allocate", 0)
    b.append([0], [6])  # 2 pages
    pages0 = list(b.tp._tables[0].pages)
    b.retain(pages0)
    queue["j"], queue["t"] = list(pages0), list(pages0)
    b("free_seq", 0)  # the holds keep both pages live
    b("allocate", 1)
    b("attach_prefix", 1, pages0, 6)
    # 2 more tokens: the CoW of the shared tail; 4 pages free, so no call
    b.append([1], [2])
    b("allocate", 2)
    b.append([2], [8])  # 2 pages: 2 free, still no call
    # 9 more tokens on 2: 3 pages, and only 0 free: the reclaimer releases
    # the held pages until it runs dry, then the claim fails with nothing
    # changed
    with pytest.raises(jkv.PagePoolExhausted):
        b.jp.append_tokens([2], [9])
    with pytest.raises(tkv.PagePoolExhausted):
        b.tp.append_tokens([2], [9])
    _same(b.jp, b.tp)
    assert queue["t"] == [] and b.tp.length(2) == 8


def _cache_pair(dtype="float32", pages=40, max_pages=None):
    jp, tp = _pool_pair(dtype, pages=pages)
    return (jp, tp, jprefix.PrefixCache(jp, max_pages=max_pages),
            tprefix.PrefixCache(tp, max_pages=max_pages))


def _same_cache(jc, tc):
    assert jc.stats() == tc.stats()
    assert {k: (e.parent, e.tokens, e.page, e.last_used, e.ns,
                dict(e.children)) for k, e in jc._entries.items()} == \
        {k: (e.parent, e.tokens, e.page, e.last_used, e.ns,
             dict(e.children)) for k, e in tc._entries.items()}
    assert jc._roots == tc._roots and jc._seq_keys == tc._seq_keys
    assert jc.locked_pages() == tc.locked_pages()
    _same(jc.pool, tc.pool)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_pages", [None, 5])
def test_prefix_cache_matches_the_jax_cache(dtype, max_pages):
    jp, tp, jc, tc = _cache_pair(dtype, max_pages=max_pages)
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 50, size=10).tolist()
    prompts = [shared + rng.randint(1, 50, size=n).tolist()
               for n in (3, 0, 6, 1)] + [rng.randint(1, 50, size=7).tolist()]
    prompts.append(prompts[0] + [9, 9])  # extends an inserted prompt
    for sid, p in enumerate(prompts):
        for adapter in (None, "tenant") if sid == 2 else (None,):
            jm, tm = jc.match(p, adapter), tc.match(p, adapter)
            assert (jm.keys, jm.pages, jm.tokens) == \
                (tm.keys, tm.pages, tm.tokens)
        jp.allocate(sid)
        tp.allocate(sid)
        assert jc.attach(sid, jm) == tc.attach(sid, tm)
        _same_cache(jc, tc)
        n = len(p) - tm.tokens
        for pool in (jp, tp):
            pool.append_tokens([sid], [n])
        assert jc.insert(sid, p) == tc.insert(sid, p)
        _same_cache(jc, tc)
        if sid == 2:
            assert jc.insert(sid, p, "tenant") == tc.insert(sid, p, "tenant")
            _same_cache(jc, tc)
    assert tc.stats()["hits"] >= 3
    # quarantine of a sequence that read cached pages, then retirements
    assert jc.quarantine_seq(5) == tc.quarantine_seq(5)
    _same_cache(jc, tc)
    for sid in range(len(prompts)):
        jc.forget_seq(sid)
        tc.forget_seq(sid)
        jp.free_seq(sid)
        tp.free_seq(sid)
        _same_cache(jc, tc)
    # pressure: the reclaimer releases cache-only pages, LRU leaf first
    jp.allocate(99)
    tp.allocate(99)
    short = tp.free_pages + min(2, tc.stats()["entries"])
    jp.append_tokens([99], [4 * short])
    tp.append_tokens([99], [4 * short])
    _same_cache(jc, tc)
    assert tc.stats()["evictions"] > 0
    assert jc.clear() == tc.clear()
    jp.free_seq(99)
    tp.free_seq(99)
    _same_cache(jc, tc)
    assert tp.used_pages == 0


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.tuples(st.integers(1, 40), st.integers(0, 40)),
                min_size=1, max_size=6),
       st.integers(0, 50),
       st.one_of(st.none(), st.floats(0.5, 5000.0)))
def test_plan_chunks_matches_the_jax_scheduler(seqs, cap, flops):
    prompts = [list(range(n)) for n, _ in seqs]
    positions = [min(p, n - 1) for n, p in seqs]
    assert tsched.plan_chunks(prompts, positions, cap, flops) == \
        jsched.plan_chunks(prompts, positions, cap, flop_budget=flops)
    for m in (0, 3):
        assert tsched.whole_eligible(m, cap) == jsched.whole_eligible(m, cap)
    with pytest.raises(ValueError, match="flop_budget"):
        tsched.plan_chunks(prompts, positions, cap, 0.0)


# the JAX prefix-cache tests' config (tests/test_prefix_cache.py)
SMALL = dict(vocab_size=61, d_model=16, n_head=2, n_layer=2, d_inner=32,
             max_length=64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_prefill_step_matches_the_jax_step(dtype):
    jcfg, tcfg = jgen.DecodeConfig(**SMALL), tgen.DecodeConfig(**SMALL)
    params = jgen.init_decode_params(jcfg, seed=3)
    kw = dict(num_pages=24, page_size=4, num_layers=2, num_heads=2,
              head_dim=8, dtype=dtype)
    jp, tp = jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)
    model = tgen.TransformerDecoder(tcfg, "cpu").load_jax_params(params)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 61, size=n).tolist() for n in (13, 7, 22)]
    for s in range(3):
        jp.allocate(s)
        tp.allocate(s)
    pos = [0, 0, 0]
    for sizes in ([5, 7, 9], [8, 0, 6], [0, 0, 7]):
        ids = [s for s in range(3) if sizes[s]]
        chunks = [prompts[s][pos[s]:pos[s] + sizes[s]] for s in ids]
        starts = [pos[s] for s in ids]
        want = jgen.chunk_prefill_step(params, jcfg, jp, ids, chunks, starts)
        got = model.chunk_prefill_step(tp, ids, chunks, starts)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        _same(jp, tp, exact=False)
        for s in ids:
            pos[s] += sizes[s]
    full = tgen.full_forward(params, tcfg, prompts[2], device="cpu")[-1]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy()[-1], full, **TOL)


def test_chunk_prefill_refuses_an_evicted_table():
    tcfg = tgen.DecodeConfig(**SMALL)
    model = tgen.TransformerDecoder(tcfg, "cpu").load_jax_params(
        tgen.init_decode_params(tcfg, seed=3))
    pool = tkv.KVCachePool(16, 4, 2, 2, 8, device="cpu")
    pool.allocate(0)
    pool.append_tokens([0], [20])
    assert pool.evict_interior(0, 4) > 0
    free = pool.free_pages
    with pytest.raises(ValueError, match="window-evicted"):
        model.chunk_prefill_step(pool, [0], [[1, 2]], [20])
    assert pool.free_pages == free and pool.length(0) == 20


def test_loop_refuses_a_cache_of_another_pool():
    tcfg = tgen.DecodeConfig(**SMALL)
    pool = tkv.KVCachePool(16, 4, 2, 2, 8, device="cpu")
    other = tkv.KVCachePool(16, 4, 2, 2, 8, device="cpu")
    params = tgen.init_decode_params(tcfg)
    with pytest.raises(ValueError, match="different pool"):
        tgen.ContinuousBatchingLoop(params, tcfg, pool, device="cpu",
                                    prefix_cache=tprefix.PrefixCache(other))
    with pytest.raises(ValueError, match="prefill_flops needs"):
        tgen.ContinuousBatchingLoop(params, tcfg, pool, device="cpu",
                                    prefill_flops=100.0)
    with pytest.raises(ValueError, match="prefill_chunk"):
        tgen.ContinuousBatchingLoop(params, tcfg, pool, device="cpu",
                                    prefill_chunk=-1)


COUNTERS = ("steps", "prefill_steps", "decode_steps", "spec_steps",
            "drafted_tokens", "accepted_tokens", "rolled_back_tokens",
            "prefix_hits", "prefix_misses", "cached_prefill_tokens",
            "prefill_tokens", "max_prefill_tokens_step", "pages_evicted",
            "max_decode_table_pages", "quarantined")


def _run_both(cfg_kw, prompts, max_new, pool_kw, seed, d=0, window=None,
              sinks=0, **loop_kw):
    jcfg, tcfg = jgen.DecodeConfig(**cfg_kw), tgen.DecodeConfig(**cfg_kw)
    params = jgen.init_decode_params(jcfg, seed=seed)
    jp, tp = jkv.KVCachePool(**pool_kw), tkv.KVCachePool(device="cpu",
                                                         **pool_kw)
    jc, tc = jprefix.PrefixCache(jp), tprefix.PrefixCache(tp)
    jloop = jgen.ContinuousBatchingLoop(
        params, jcfg, jp, paged_impl="reference", prefix_cache=jc,
        speculate=d, drafter=jspec.PromptLookupDrafter(max_draft=d)
        if d else None, **loop_kw)
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tp, device="cpu",
                                        prefix_cache=tc, speculate=d,
                                        **loop_kw)
    jres = jloop.run([jgen.DecodeRequest(p, max_new, window=window,
                                         sinks=sinks) for p in prompts])
    tres = tloop.run([tgen.DecodeRequest(p, max_new, window=window,
                                         sinks=sinks) for p in prompts])
    for jr, tr in zip(jres, tres):
        assert tr.error is None and tr.tokens == jr.tokens
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, **TOL)
    for key in COUNTERS:
        assert getattr(tloop, key) == getattr(jloop, key), key
    for key in STATS:
        assert tp.stats()[key] == jp.stats()[key], key
    assert tp.check_invariants()["ok"]
    assert jc.clear() == tc.clear()
    assert tp.used_pages == 0 and tp.check_invariants()["ok"]
    return params, tcfg, tloop, tres


@pytest.mark.parametrize("prefill_chunk", [0, 8])
def test_eight_way_shared_prefix_loop_matches_the_jax_loop(prefill_chunk):
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 61, size=18).tolist()
    prompts = [shared + rng.randint(1, 61, size=2).tolist()
               for _ in range(8)]
    params, tcfg, loop, res = _run_both(
        SMALL, prompts, 4, dict(num_pages=96, page_size=4, num_layers=2,
                                num_heads=2, head_dim=8), 5,
        max_batch=1, prefill_chunk=prefill_chunk)
    assert loop.prefix_hits == 7 and loop.prefix_misses == 1
    assert loop.cached_prefill_tokens == 7 * 16
    if prefill_chunk:
        assert loop.max_prefill_tokens_step == prefill_chunk
    for p, r in zip(prompts[:2], res):
        assert r.tokens == tgen.full_decode(params, tcfg, p, 4,
                                            device="cpu")[0]


# the JAX speculative parity matrix's config, grouped 8 over 4 KV heads
GQA = dict(vocab_size=61, d_model=32, n_head=8, n_layer=2, d_inner=48,
           max_length=48, n_kv_head=4)


def _shared_prompts(seed=4):
    """Seven prompts, six opening with one 18-token prefix, the last
    extending the first (a partly filled cached tail page attaches)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 61, size=18).tolist()
    out = [shared + rng.randint(1, 61, size=n).tolist()
           for n in (3, 5, 1, 6, 2)]
    out.insert(3, rng.randint(1, 61, size=9).tolist())
    out.append(out[0] + [7, 8])
    return out


def test_gqa_int8_speculative_loop_matches_the_jax_loop():
    _, _, loop, _ = _run_both(
        GQA, _shared_prompts(), 6,
        dict(num_pages=40, page_size=4, num_layers=2, num_heads=8,
             head_dim=4, num_kv_heads=4, dtype="int8"), 4, d=2,
        max_batch=2, prefill_chunk=8)
    assert loop.spec_steps > 0 and loop.prefix_hits > 0
    assert loop.max_prefill_tokens_step <= 8


def test_windowed_loop_over_shared_pages_matches_the_jax_loop():
    _, _, loop, _ = _run_both(
        GQA, _shared_prompts(6), 8,
        dict(num_pages=40, page_size=4, num_layers=2, num_heads=8,
             head_dim=4, num_kv_heads=4), 6, window=8, sinks=4,
        max_batch=3, prefill_chunk=16, prefill_flops=150.0, table_block=2)
    assert loop.pages_evicted > 0 and loop.prefix_hits > 0
