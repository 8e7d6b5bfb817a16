"""The port's long-context serving (paddle_tpu_torch: explicit page starts,
the window + sink mask and two-level tables in paged attention, the
pool's evict_interior / page_tables_with_starts / two_level_tables, and
the loop's window=, sinks= and table_block=) against the JAX package's,
on the CPU.  The same numpy inputs and the same init_decode_params seed
go to both packages.

Tolerances:
- the plain windowed / two-level version against JAX
  ``paged_decode_attention(page_starts=, windows=, sinks=)`` in its
  reference and interpret implementations: rtol/atol 2e-5 on valid rows
  (``KERNEL_TOL`` of test_torch_speculative.py);
- loop and oracle logits: rtol/atol 1e-4 (``TOL`` there);
- pool bookkeeping (page ids, starts, lengths, both table views, free
  list, counters) and int8 scales: EQUAL;
- tokens: identical.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")

from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
PAD = tpaged.PAD_START


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# -- 1: the plain walk against the JAX kernel ---------------------------------

# (name, Sq, G, dtype, table, block_size, windowed): table "flat" is an
# unevicted table with explicit starts i * page_size, "compacted" an
# evicted one, "two_level" the compacted tables as L1/L2 blocks, and
# "implicit" a flat table with windows and no starts
WALK_CASES = [
    ("flat_sq1_g1_f32", 1, 1, "float32", "flat", 0, True),
    ("flat_sq4_g2_i8", 4, 2, "int8", "flat", 0, True),
    ("starts_only_sq4_g1_f32", 4, 1, "float32", "compacted", 0, False),
    ("compacted_sq1_g4_f32", 1, 4, "float32", "compacted", 0, True),
    ("compacted_sq4_g1_i8", 4, 1, "int8", "compacted", 0, True),
    ("compacted_sq4_g2_f32", 4, 2, "float32", "compacted", 0, True),
    ("implicit_sq1_g2_f32", 1, 2, "float32", "implicit", 0, True),
    ("two_level_bs1_sq1_g2_f32", 1, 2, "float32", "two_level", 1, True),
    ("two_level_bs3_sq4_g4_i8", 4, 4, "int8", "two_level", 3, True),
    ("two_level_bs4_sq4_g1_f32", 4, 1, "float32", "two_level", 4, True),
    ("two_level_bs3_sq1_g2_i8", 1, 2, "int8", "two_level", 3, True),
    ("window1_sinks0_sq4_g2_f32", 4, 2, "float32", "compacted", 0, "w1"),
]
PS, HKV, D = 4, 2, 8
LENGTHS = [26, 9, 5, 19]
QLENS = [3, 1, 4, 4]
WINDOWS = [6, PAD, 3, 9]   # one row without a window in a windowed batch
SINKS = [4, 0, 0, 2]


def _evict(length, n_pages, window, sinks):
    """The page indices evict_interior keeps (st < sinks or st + ps >
    length - window), taken at the length before the step's appends."""
    return [i for i in range(n_pages)
            if i * PS < sinks or i * PS + PS > length - window]


def _two_level(rows, bs):
    """(l1, l2, starts) of per-row (pages, starts) lists, as
    KVCachePool.two_level_tables lays them out (block 0 the pad block)."""
    n_l1 = max(-(-len(p) // bs) for p, _ in rows)
    l2 = [np.zeros(bs, np.int32)]
    st = [np.full(bs, PAD, np.int32)]
    l1 = np.zeros((len(rows), n_l1), np.int32)
    for i, (pages, starts) in enumerate(rows):
        for j in range(-(-len(pages) // bs)):
            blk = np.zeros(bs, np.int32)
            sblk = np.full(bs, PAD, np.int32)
            chunk = pages[j * bs:(j + 1) * bs]
            blk[:len(chunk)] = chunk
            sblk[:len(chunk)] = starts[j * bs:(j + 1) * bs]
            l1[i, j] = len(l2)
            l2.append(blk)
            st.append(sblk)
    return l1, np.stack(l2), np.stack(st)


def _walk_inputs(seed, Sq, G, dtype, table, bs, windowed, nan_pad=False):
    rng = np.random.RandomState(seed)
    B = len(LENGTHS)
    qlens = np.array(QLENS if Sq > 1 else [1] * B, np.int32)
    windows = np.array([1, 1, PAD, 1] if windowed == "w1" else WINDOWS,
                       np.int32)
    sinks = np.zeros(B, np.int32) if windowed == "w1" \
        else np.array(SINKS, np.int32)
    n_pages = [-(-n // PS) for n in LENGTHS]
    P = sum(n_pages) + 3
    perm = rng.permutation(np.arange(1, P))
    rows, at = [], 0
    for b, n in enumerate(n_pages):
        pages = perm[at:at + n].tolist()
        at += n
        keep = list(range(n))
        if table in ("compacted", "two_level") and windows[b] != PAD:
            keep = _evict(LENGTHS[b] - qlens[b], n, windows[b], sinks[b])
        rows.append(([pages[i] for i in keep], [i * PS for i in keep]))
    maxp = max(len(p) for p, _ in rows)
    tables = np.zeros((B, maxp), np.int32)
    starts = np.full((B, maxp), PAD, np.int32)
    for b, (pages, st) in enumerate(rows):
        tables[b, :len(pages)] = pages
        starts[b, :len(st)] = st
    kf = rng.standard_normal((HKV, P, PS, D)).astype(np.float32)
    vf = rng.standard_normal((HKV, P, PS, D)).astype(np.float32)
    if nan_pad:
        # a NaN in page 0, the padding page: it must never reach a result
        # (the JAX reference's gather would carry it through 0 * NaN)
        kf[:, 0] = np.nan
        vf[:, 0] = np.nan
    if dtype == "int8":
        ks = (np.nan_to_num(np.abs(kf)).max(axis=(0, 2, 3)) / 127.0)
        vs = (np.nan_to_num(np.abs(vf)).max(axis=(0, 2, 3)) / 127.0)
        ks, vs = ks.astype(np.float32) + 1e-3, vs.astype(np.float32) + 1e-3
        kp = np.clip(np.round(np.nan_to_num(kf) / ks[None, :, None, None]),
                     -127, 127).astype(np.int8)
        vp = np.clip(np.round(np.nan_to_num(vf) / vs[None, :, None, None]),
                     -127, 127).astype(np.int8)
        if nan_pad:
            ks[0] = vs[0] = np.nan
    else:
        kp, vp, ks, vs = kf, vf, None, None
    q = rng.standard_normal((B, HKV * G, Sq, D)).astype(np.float32)
    kw = dict(q_lengths=qlens if Sq > 1 else None,
              windows=windows if windowed else None,
              sinks=sinks if windowed else None)
    if table == "two_level":
        l1, l2, st = _two_level(rows, bs)
        jt = jpaged.TwoLevelTables(l1, l2, st, bs)
        tt = tpaged.TwoLevelTables(l1, l2, st, bs)
        jst = tst = None
    else:
        jt = tt = tables
        jst = tst = None if table == "implicit" else starts
    return q, kp, vp, ks, vs, jt, tt, jst, tst, qlens, kw


@pytest.mark.parametrize("case", WALK_CASES, ids=[c[0] for c in WALK_CASES])
def test_plain_walk_matches_jax_reference_and_interpret(case):
    name, Sq, G, dtype, table, bs, windowed = case
    q, kp, vp, ks, vs, jt, tt, jst, tst, qlens, kw = _walk_inputs(
        len(name), Sq, G, dtype, table, bs, windowed)
    tkw = {k: _t(v) for k, v in kw.items()}
    got = tpaged.paged_decode_attention(
        _t(q), _t(kp), _t(vp), tt, LENGTHS, page_starts=_t(tst),
        k_scales=_t(ks), v_scales=_t(vs), **tkw).numpy()
    direct = tpaged.paged_windowed_reference(
        _t(q), _t(kp), _t(vp), tt, LENGTHS, tkw["q_lengths"], _t(tst),
        tkw["windows"], tkw["sinks"], None, _t(ks), _t(vs)).numpy()
    np.testing.assert_array_equal(got, direct)
    for b in range(len(LENGTHS)):
        assert np.isfinite(got[b, :, :qlens[b]]).all()
    for impl in ("reference", "interpret"):
        want = np.asarray(jpaged.paged_decode_attention(
            q, kp, vp, jt, np.array(LENGTHS, np.int32), impl=impl,
            page_starts=jst, k_scales=ks, v_scales=vs, **kw))
        for b in range(len(LENGTHS)):
            np.testing.assert_allclose(got[b, :, :qlens[b]],
                                       want[b, :, :qlens[b]], **KERNEL_TOL)


def test_eviction_leaves_the_windowed_result_unchanged():
    """The windowed walk over the compacted tables equals the windowed
    walk over the full tables (the identity eviction relies on), and the
    two-level view of the compacted tables equals their flat view; a NaN
    in the padding page reaches no valid row."""
    for seed, Sq, G, dtype in ((17, 4, 2, "float32"), (5, 1, 1, "int8")):
        outs = {}
        for table, bs in (("flat", 0), ("compacted", 0), ("two_level", 3)):
            q, kp, vp, ks, vs, _, tt, _, tst, qlens, kw = _walk_inputs(
                seed, Sq, G, dtype, table, bs, True, nan_pad=True)
            outs[table] = tpaged.paged_decode_attention(
                _t(q), _t(kp), _t(vp), tt, LENGTHS, page_starts=_t(tst),
                k_scales=_t(ks), v_scales=_t(vs),
                **{k: _t(v) for k, v in kw.items()}).numpy()
        for b in range(len(LENGTHS)):
            assert np.isfinite(outs["compacted"][b, :, :qlens[b]]).all()
            np.testing.assert_allclose(outs["compacted"][b, :, :qlens[b]],
                                       outs["flat"][b, :, :qlens[b]],
                                       **KERNEL_TOL)
        np.testing.assert_array_equal(outs["two_level"], outs["compacted"])


def test_walk_contract_validation_and_cpu_counts_no_launch():
    q, kp, vp, _, _, _, tt, _, tst, _, kw = _walk_inputs(
        3, 4, 2, "float32", "compacted", 0, True)
    tkw = {k: _t(v) for k, v in kw.items()}
    l1, l2, st = _two_level([([1, 2], [0, 4])] * 4, 2)
    two = tpaged.TwoLevelTables(l1, l2, st, 2)
    assert two.max_pages == 2
    flat_t, flat_s = two.flatten()
    assert flat_t.tolist() == [[1, 2]] * 4 and flat_s.tolist() == [[0, 4]] * 4
    before = (dict(tpaged.paged_decode_attention.launches_by_table),
              tpaged.paged_decode_attention.windowed_launches)
    with pytest.raises(ValueError, match="page_starts is the flat"):
        tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), two, LENGTHS,
                                      page_starts=_t(tst), **tkw)
    with pytest.raises(ValueError, match="pass windows"):
        tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tt, LENGTHS,
                                      page_starts=_t(tst),
                                      q_lengths=tkw["q_lengths"],
                                      sinks=tkw["sinks"])
    out = tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tt, LENGTHS,
                                        page_starts=_t(tst), **tkw)
    assert out.shape == q.shape
    assert (dict(tpaged.paged_decode_attention.launches_by_table),
            tpaged.paged_decode_attention.windowed_launches) == before
    assert set(before[0]) == {"flat", "starts", "two_level"}


# -- 2: the pool --------------------------------------------------------------

def _pool_pair(dtype, pages=40):
    kw = dict(num_pages=pages, page_size=PS, num_layers=2, num_heads=4,
              head_dim=8, num_kv_heads=2, dtype=dtype)
    return jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)


def _append_both(jpool, tpool, ids, counts, rng):
    jp, js = jpool.append_tokens(ids, counts)
    tp, ts = tpool.append_tokens(ids, counts)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(js, ts)
    for li in range(jpool.num_layers):
        k = rng.standard_normal((len(jp), 2, 8)).astype(np.float32)
        v = rng.standard_normal((len(jp), 2, 8)).astype(np.float32)
        jpool.write_kv(li, jp, js, k, v)
        tpool.write_kv(li, tp, ts, torch.from_numpy(k), torch.from_numpy(v))


def _same_pools(jpool, tpool):
    ids = sorted(tpool._tables)
    assert ids == sorted(jpool._tables)
    assert jpool._free == tpool._free
    for key in ("pages_evicted", "page_frees", "page_allocs",
                "token_appends", "tokens_truncated"):
        assert jpool.stats()[key] == tpool.stats()[key], key
    for s in ids:
        assert tpool._tables[s].starts == jpool._tables[s].starts
    if ids:
        for a, b in zip(jpool.page_table_batch(ids),
                        tpool.page_table_batch(ids)):
            np.testing.assert_array_equal(a, b)
        want = jpool.page_tables_with_starts(ids)
        got = tpool.page_tables_with_starts(ids)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b)
        for bs in (1, 3):
            jtl, jln = jpool.two_level_tables(ids, bs)
            ttl, tln = tpool.two_level_tables(ids, bs)
            np.testing.assert_array_equal(jln, tln)
            for f in ("l1", "l2", "starts"):
                np.testing.assert_array_equal(getattr(jtl, f),
                                              getattr(ttl, f))
            assert ttl.block_size == bs and ttl.max_pages == jtl.max_pages
            ft, fs = (a.numpy() for a in ttl.flatten())
            for i, s in enumerate(ids):
                live = len(tpool._tables[s].pages)
                np.testing.assert_array_equal(ft[i, :live], got[0][i, :live])
                np.testing.assert_array_equal(fs[i, :live], got[1][i, :live])
                assert (fs[i, live:] == PAD).all()
    if tpool.quantized:
        np.testing.assert_array_equal(tpool.k_scales.numpy(), jpool.k_scales)
        np.testing.assert_array_equal(tpool.v_scales.numpy(), jpool.v_scales)
    report = tpool.check_invariants()
    assert report["ok"], report
    assert jpool.check_invariants()["ok"]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_pool_history_matches_jax(dtype):
    """Allocate, append, evict, append across a page, evict again,
    truncate, the interior-gap error and free, against the JAX pool
    after every step; dropped pages' int8 scales are cleared."""
    jpool, tpool = _pool_pair(dtype)
    rng = np.random.RandomState(7)
    for s in (0, 1, 2):
        jpool.allocate(s)
        tpool.allocate(s)
    _append_both(jpool, tpool, [0, 1, 2], [30, 5, 13], rng)
    _same_pools(jpool, tpool)
    dropped = [p for p, st in zip(tpool._tables[0].pages, range(0, 30, PS))
               if st >= 4 and st + PS <= 30 - 6]
    assert jpool.evict_interior(0, 6, 4) == tpool.evict_interior(0, 6, 4) \
        == len(dropped) > 0
    assert tpool._tables[0].starts == [0, 24, 28]
    if dtype == "int8":
        assert (tpool.k_scales[:, dropped] == 0).all()
        assert (tpool.v_scales[:, dropped] == 0).all()
    _same_pools(jpool, tpool)
    assert tpool.evict_interior(0, 6, 4) == jpool.evict_interior(0, 6, 4) \
        == 0  # nothing more to drop at this length
    _append_both(jpool, tpool, [0, 1, 2], [3, 1, 3], rng)   # 0 crosses a page
    _same_pools(jpool, tpool)
    assert tpool._tables[0].starts == [0, 24, 28, 32]
    _append_both(jpool, tpool, [0, 2], [5, 4], rng)
    for s, w, k in ((0, 6, 4), (2, 5, 0)):
        assert jpool.evict_interior(s, w, k) == tpool.evict_interior(s, w, k)
    _same_pools(jpool, tpool)
    assert jpool.truncate_seq(0, 34) == tpool.truncate_seq(0, 34)
    _same_pools(jpool, tpool)
    gap = tpool._tables[0].starts[0] + PS + 1  # inside the evicted gap
    for pool in (jpool, tpool):
        with pytest.raises(ValueError, match="interior gap"):
            pool.truncate_seq(0, gap)
    _same_pools(jpool, tpool)
    _append_both(jpool, tpool, [0, 1], [6, 2], rng)
    _same_pools(jpool, tpool)
    for s in (1, 0, 2):
        assert jpool.free_seq(s) == tpool.free_seq(s)
        _same_pools(jpool, tpool)
    assert tpool.used_pages == 0
    assert tpool.stats()["pages_evicted"] > 0


def test_pool_argument_errors_and_planted_bad_start():
    _, tpool = _pool_pair("float32")
    tpool.allocate(0)
    tpool.append_tokens([0], [24])
    with pytest.raises(ValueError, match="window"):
        tpool.evict_interior(0, 0)
    with pytest.raises(ValueError, match="sinks"):
        tpool.evict_interior(0, 4, -1)
    with pytest.raises(ValueError, match="block_size"):
        tpool.two_level_tables([0], 0)
    assert tpool.evict_interior(0, 6, 4) > 0
    assert tpool.check_invariants()["ok"]
    tpool._tables[0].starts[1] += 1  # no longer a page multiple
    report = tpool.check_invariants()
    assert not report["ok"] and report["length_mismatches"] == [0]
    tpool._tables[0].starts[1] -= 1
    tpool._tables[0].starts[-1] -= PS  # the tail no longer covers length
    assert tpool.check_invariants()["length_mismatches"] == [0]


def test_window_mask_matches_jax():
    for args in ((40, 12, 8, 4, 4), (33, 5, 1, 0, 4), (20, 20, 3, 2, 1),
                 (50, 10, 16, 16, 16)):
        np.testing.assert_array_equal(tgen.window_mask(*args),
                                      jgen.window_mask(*args))
    with pytest.raises(ValueError, match="window"):
        tgen.window_mask(8, 4, 0, 0, 4)


# -- 3: the loop against the JAX loop and the masked oracle ------------------

WIN, SNK, MAX_NEW = 8, 4, 16
LCFG = dict(vocab_size=64, d_model=32, n_head=4, n_kv_head=2, n_layer=2,
            max_length=96, eos_id=None)
_rng = np.random.default_rng(1)
PROMPTS = tuple(tuple(int(t) for t in _rng.integers(0, 64, n))
                for n in (12, 7, 20))


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = jgen.DecodeConfig(**LCFG), tgen.DecodeConfig(**LCFG)
    return jcfg, tcfg, jgen.init_decode_params(jcfg, seed=0)


@functools.lru_cache(maxsize=None)
def _oracle(window, sinks):
    """The port's full_decode of each prompt, (tokens, logits rows),
    under the masked oracle (window None: the causal one).  Both oracles
    are held against the JAX package's: the causal one in
    test_torch_serving.py, the masked one in
    test_masked_oracle_matches_jax."""
    _, tcfg, params = _setup()
    kw = ({"window": window, "sinks": sinks, "page_size": PS}
          if window else {})
    return [tgen.full_decode(params, tcfg, list(p), MAX_NEW, device="cpu",
                             **kw) for p in PROMPTS]


def test_masked_oracle_matches_jax():
    """full_decode under window_mask against the JAX package's, on the
    longest prompt (the JAX oracle compiles anew for every length, so it
    runs a few tokens only)."""
    jcfg, tcfg, params = _setup()
    kw = dict(window=WIN, sinks=SNK, page_size=PS)
    want = jgen.full_decode(params, jcfg, list(PROMPTS[2]), 6, **kw)
    got = tgen.full_decode(params, tcfg, list(PROMPTS[2]), 6, device="cpu",
                           **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, **TOL)
    # row 0 is the last prompt position (full attention); row 1 is the
    # first decode query, where the mask bites
    causal = tgen.full_decode(params, tcfg, list(PROMPTS[2]), 2,
                              device="cpu")[1]
    np.testing.assert_array_equal(got[1][0], causal[0])
    assert np.abs(got[1][1] - causal[1]).max() > 1e-2


@functools.lru_cache(maxsize=None)
def _arm(window=None, sinks=0, dtype="float32", speculate=0,
         table_block=None):
    """One replay through both loops: (JAX loop, JAX results, port loop,
    port results, port pool)."""
    jcfg, tcfg, params = _setup()
    pk = dict(num_pages=256, page_size=PS, num_layers=2, num_heads=4,
              head_dim=8, num_kv_heads=2, dtype=dtype)
    jpool = jkv.KVCachePool(**pk)
    tpool = tkv.KVCachePool(device="cpu", **pk)
    jloop = jgen.ContinuousBatchingLoop(params, jcfg, jpool, max_batch=3,
                                        speculate=speculate,
                                        table_block=table_block,
                                        check_every=1)
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tpool, max_batch=3,
                                        device="cpu", speculate=speculate,
                                        table_block=table_block)
    jres = jloop.run([jgen.DecodeRequest(list(p), MAX_NEW, window=window,
                                         sinks=sinks) for p in PROMPTS])
    tres = tloop.run([tgen.DecodeRequest(list(p), MAX_NEW, window=window,
                                         sinks=sinks) for p in PROMPTS])
    report = tpool.check_invariants()
    assert report["ok"] and report["used_pages"] == 0, report
    return jloop, jres, tloop, tres


def _assert_loop_like_jax(jloop, jres, tloop, tres):
    for jr, tr in zip(jres, tres):
        assert tr.error is None and tr.tokens == jr.tokens
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, **TOL)
    for key in ("pages_evicted", "max_decode_table_pages", "steps",
                "decode_steps", "spec_steps", "drafted_tokens"):
        assert getattr(tloop, key) == getattr(jloop, key), key


# (name, arm keywords, oracle window or None): the counterparts of the
# JAX package's long-context loop matrix
LOOP_ARMS = [
    ("unwindowed", dict(), None),
    ("windowed", dict(window=WIN, sinks=SNK), WIN),
    ("windowed_two_level", dict(window=WIN, sinks=SNK, table_block=2), WIN),
    ("windowed_speculation", dict(window=WIN, sinks=SNK, speculate=3), WIN),
    ("unwindowed_two_level", dict(table_block=3), None),
]


@pytest.mark.parametrize("arm", LOOP_ARMS, ids=[a[0] for a in LOOP_ARMS])
def test_loop_matches_jax_loop_and_masked_oracle(arm):
    name, kw, window = arm
    jloop, jres, tloop, tres = _arm(**kw)
    _assert_loop_like_jax(jloop, jres, tloop, tres)
    for tr, (toks, rows) in zip(tres, _oracle(window, SNK if window else 0)):
        assert tr.tokens == toks
        for a, b in zip(tr.logits, rows):
            np.testing.assert_allclose(a, b, **TOL)
    if window:
        assert tloop.pages_evicted > 0
        assert tloop.max_decode_table_pages < max(
            -(-(len(p) + MAX_NEW) // PS) for p in PROMPTS)
    else:
        assert tloop.pages_evicted == 0
    if kw.get("speculate"):
        assert tloop.drafted_tokens > 0  # speculation ran under the window
    if "table_block" in kw:
        flat = _arm(**{k: v for k, v in kw.items() if k != "table_block"})
        assert [r.tokens for r in tres] == [r.tokens for r in flat[3]]
        assert tloop.pages_evicted == flat[2].pages_evicted


@pytest.mark.parametrize("speculate", [0, 2])
def test_windowed_int8_flat_equals_two_level(speculate):
    """int8 pages re-quantize, so the fp32 oracle is only close; the flat
    and two-level walks over the same int8 pool gather the same pages and
    must give the same tokens and logits, as the JAX loop's do."""
    kw = dict(window=WIN, sinks=SNK, dtype="int8", speculate=speculate)
    flat = _arm(**kw)
    two = _arm(table_block=4, **kw)
    _assert_loop_like_jax(*flat)
    _assert_loop_like_jax(*two)
    for a, b in zip(flat[3], two[3]):
        assert a.tokens == b.tokens
        for x, y in zip(a.logits, b.logits):
            np.testing.assert_array_equal(x, y)
    assert flat[2].pages_evicted == two[2].pages_evicted > 0


def test_windowed_steps_match_jax_steps():
    """decode_step and verify_step with windows and both table views, on
    an evicted pool, against the JAX steps."""
    jcfg, tcfg, params = _setup()
    model = tgen.TransformerDecoder(tcfg, device="cpu").load_jax_params(
        params)
    jpool, tpool = _pool_pair("float32", pages=64)
    ids, prompts = [0, 1], [list(PROMPTS[2]) * 2, list(PROMPTS[1])]
    for s in ids:
        jpool.allocate(s)
        tpool.allocate(s)
    jgen.prefill_step(params, jcfg, jpool, ids, prompts, force="jax")
    model.prefill_step(tpool, ids, prompts)
    for pool in (jpool, tpool):
        assert pool.evict_interior(0, WIN, SNK) > 0
    win = np.array([WIN, PAD], np.int32)
    snk = np.array([SNK, 0], np.int32)
    pos = np.array([len(p) for p in prompts])
    for tb in (None, 2):
        want = jgen.decode_step(params, jcfg, jpool, ids, [3, 5], pos,
                                impl="reference", windows=win, sinks=snk,
                                table_block=tb)
        got = model.decode_step(tpool, ids, [3, 5], pos, windows=win,
                                sinks=snk, table_block=tb)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        pos = pos + 1
        blocks = [[7, 8, 9], [4]]
        want = jgen.verify_step(params, jcfg, jpool, ids, blocks, pos,
                                impl="reference", pad_to=3, windows=win,
                                sinks=snk, table_block=tb)
        got = model.verify_step(tpool, ids, blocks, pos, pad_to=3,
                                windows=win, sinks=snk, table_block=tb)
        for b, n in enumerate(len(x) for x in blocks):
            np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n],
                                       **TOL)
        pos = pos + np.array([len(x) for x in blocks])
    _same_pools(jpool, tpool)


def test_longctx_validation_errors():
    _, tcfg, params = _setup()
    pool = tkv.KVCachePool(64, PS, 2, 4, 8, num_kv_heads=2, device="cpu")
    with pytest.raises(ValueError, match="table_block"):
        tgen.ContinuousBatchingLoop(params, tcfg, pool, device="cpu",
                                    table_block=0)
    for bad, match in ((tgen.DecodeRequest([1, 2, 3], 4, window=0), "window"),
                       (tgen.DecodeRequest([1, 2, 3], 4, sinks=2), "sinks"),
                       (tgen.DecodeRequest([1, 2, 3], 4, window=4, sinks=-1),
                        "sinks")):
        loop = tgen.ContinuousBatchingLoop(params, tcfg, pool, max_batch=1,
                                           device="cpu")
        with pytest.raises(ValueError, match=match):
            loop.run([bad])
        assert pool.used_pages == 0  # refused before any page was claimed
