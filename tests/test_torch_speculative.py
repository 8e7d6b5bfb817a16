"""The port's speculative decoding and int8 pools (paddle_tpu_torch:
serving/speculative.py, KVCachePool.truncate_seq and int8 writes, the
verify and int8 variants of paged attention, verify_step and the loop's
speculate=) against the JAX package's, on the CPU.  The same numpy
inputs and the same init_decode_params seed go to both packages.

Tolerances:
- plain verify against JAX ``paged_decode_attention(q_lengths=)``:
  rtol/atol 2e-5, the JAX file's own tolerance for its two verify
  implementations (float32 dots and softmaxes in different orders leave
  about 1e-7);
- verify_step and loop logits: rtol/atol 1e-4, as the port's serving
  tests hold its steps (a 2-layer post-norm stack in float32 leaves
  about 1e-6; a wrong mask, position or page moves logits by O(0.1));
- int8 pages and scales: EQUAL.  Both pools compute the scale as a
  float32 division and round half to even from a float32 division, so
  the same K/V rows give the same bytes;
- tokens: identical.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")
jspec = importlib.import_module("paddle_tpu.serving.speculative")

from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving import speculative as tspec  # noqa: E402

KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
# the JAX parity matrix's config (tests/test_speculative.py)
CFG = dict(vocab_size=61, d_model=32, n_head=8, n_layer=2, d_inner=48,
           max_length=48)


def _cfgs(**over):
    kw = dict(CFG, **over)
    return jgen.DecodeConfig(**kw), tgen.DecodeConfig(**kw)


def _pools(cfg, num_pages, dtype="float32", page_size=4):
    kw = dict(num_pages=num_pages, page_size=page_size,
              num_layers=cfg.n_layer, num_heads=cfg.n_head,
              head_dim=cfg.head_dim, num_kv_heads=cfg.num_kv_heads)
    return (jkv.KVCachePool(dtype=dtype, **kw),
            tkv.KVCachePool(dtype=dtype, device="cpu", **kw))


def _prompts(seed=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, CFG["vocab_size"], size=n).tolist()
            for n in (6, 9, 4, 11)]


# -- 1, 2: the plain verify version ------------------------------------------

def _verify_inputs(rng, G, dtype, Hkv=2, P=16, ps=4, D=8):
    """A random pool layer, tables, ragged lengths / q_lengths (q_length 1,
    and q_length equal to the whole length) and queries."""
    B = 4
    kf = rng.standard_normal((Hkv, P, ps, D)).astype(np.float32)
    vf = rng.standard_normal((Hkv, P, ps, D)).astype(np.float32)
    if dtype == "int8":
        ks = (np.abs(kf).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
        vs = (np.abs(vf).max(axis=(0, 2, 3)) / 127.0).astype(np.float32)
        kp = np.clip(np.round(kf / ks[None, :, None, None]),
                     -127, 127).astype(np.int8)
        vp = np.clip(np.round(vf / vs[None, :, None, None]),
                     -127, 127).astype(np.int8)
    else:
        kp, vp, ks, vs = kf, vf, None, None
    tables = rng.randint(0, P, size=(B, 5)).astype(np.int32)
    lengths = np.array([18, 7, 4, 13], np.int32)
    qlens = np.array([3, 1, 4, 4], np.int32)  # row 2: q_length == length
    q = rng.standard_normal((B, Hkv * G, 4, D)).astype(np.float32)
    return q, kp, vp, ks, vs, tables, lengths, qlens


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_verify_matches_jax_reference_and_interpret(G, dtype):
    rng = np.random.RandomState(10 + G)
    q, kp, vp, ks, vs, tables, lengths, qlens = _verify_inputs(rng, G, dtype)
    got = tpaged.paged_decode_attention(
        _t(q), _t(kp), _t(vp), tables, lengths, q_lengths=qlens,
        k_scales=_t(ks), v_scales=_t(vs)).numpy()
    direct = tpaged.paged_verify_reference(
        _t(q), _t(kp), _t(vp), tables, lengths, qlens, None, _t(ks),
        _t(vs)).numpy()
    np.testing.assert_array_equal(got, direct)
    for impl in ("reference", "interpret"):
        want = np.asarray(jpaged.paged_decode_attention(
            q, kp, vp, tables, lengths, impl=impl, q_lengths=qlens,
            k_scales=ks, v_scales=vs))
        for b in range(len(lengths)):
            np.testing.assert_allclose(got[b, :, :qlens[b]],
                                       want[b, :, :qlens[b]], **KERNEL_TOL)


def test_verify_block_rows_equal_stacked_single_token_steps():
    """Row t of a verify block equals a single-token decode with the keys
    cut at that row's position: speculation changes nothing about what
    each row attends to."""
    rng = np.random.RandomState(1)
    q, kp, vp, _, _, tables, lengths, qlens = _verify_inputs(rng, 2,
                                                             "float32")
    blk = tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tables,
                                        lengths, q_lengths=qlens).numpy()
    for b in range(len(lengths)):
        for t in range(qlens[b]):
            ln_t = lengths.copy()
            ln_t[b] = lengths[b] - qlens[b] + t + 1
            single = tpaged.paged_decode_attention(
                _t(q[:, :, t:t + 1]), _t(kp), _t(vp), tables, ln_t).numpy()
            np.testing.assert_allclose(blk[b, :, t], single[b, :, 0],
                                       **KERNEL_TOL)


def test_plain_int8_decode_matches_jax():
    rng = np.random.RandomState(4)
    q, kp, vp, ks, vs, tables, lengths, _ = _verify_inputs(rng, 2, "int8")
    got = tpaged.paged_decode_attention(
        _t(q[:, :, :1]), _t(kp), _t(vp), tables, lengths, k_scales=_t(ks),
        v_scales=_t(vs)).numpy()
    for impl in ("reference", "interpret"):
        want = jpaged.paged_decode_attention(
            q[:, :, :1], kp, vp, tables, lengths, impl=impl, k_scales=ks,
            v_scales=vs)
        np.testing.assert_allclose(got, np.asarray(want), **KERNEL_TOL)
    gathered = tpaged.gather_kv_pages(_t(kp), tables, scales=_t(ks))
    np.testing.assert_array_equal(
        gathered.numpy(),
        np.asarray(jpaged.gather_kv_pages(kp, tables, scales=ks)))


def test_verify_contract_validation_and_cpu_counts_no_launch():
    rng = np.random.RandomState(3)
    q, kp, vp, ks, vs, tables, lengths, qlens = _verify_inputs(rng, 1,
                                                               "int8")
    before = dict(tpaged.paged_decode_attention.launches_by_variant)
    with pytest.raises(ValueError, match="q_lengths"):
        tpaged.paged_decode_attention(_t(q[:, :, :1]), _t(kp), _t(vp),
                                      tables, lengths, q_lengths=qlens,
                                      k_scales=_t(ks), v_scales=_t(vs))
    with pytest.raises(ValueError, match=">= 1 token"):
        tpaged.paged_decode_attention(_t(q[:, :, :0]), _t(kp), _t(vp),
                                      tables, lengths)
    with pytest.raises(ValueError, match="per-page k_scales"):
        tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tables,
                                      lengths, q_lengths=qlens)
    with pytest.raises(ValueError, match="together"):
        tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tables,
                                      lengths, q_lengths=qlens,
                                      k_scales=_t(ks))
    out = tpaged.paged_decode_attention(_t(q), _t(kp), _t(vp), tables,
                                        lengths, q_lengths=qlens,
                                        k_scales=_t(ks), v_scales=_t(vs))
    assert out.shape == q.shape
    assert tpaged.paged_decode_attention.launches_by_variant == before
    assert set(before) == {"decode_f32", "verify_f32", "decode_i8",
                           "verify_i8"}


# -- 3, 4: the pool -----------------------------------------------------------

def _pool_pair(dtype, pages=12, ps=4):
    kw = dict(num_pages=pages, page_size=ps, num_layers=2, num_heads=4,
              head_dim=8, num_kv_heads=2)
    return (jkv.KVCachePool(dtype=dtype, **kw),
            tkv.KVCachePool(dtype=dtype, device="cpu", **kw))


def _write_both(jpool, tpool, seq_ids, counts, rng, gain=1.0):
    jp, js = jpool.append_tokens(seq_ids, counts)
    tp, ts = tpool.append_tokens(seq_ids, counts)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(js, ts)
    for li in range(jpool.num_layers):
        k = (gain * rng.standard_normal((len(jp), 2, 8))).astype(np.float32)
        v = (gain * rng.standard_normal((len(jp), 2, 8))).astype(np.float32)
        jpool.write_kv(li, jp, js, k, v)
        tpool.write_kv(li, tp, ts, torch.from_numpy(k), torch.from_numpy(v))


def _assert_same_int8(jpool, tpool):
    np.testing.assert_array_equal(tpool.k_pages.numpy(),
                                  np.asarray(jpool.k_pages))
    np.testing.assert_array_equal(tpool.v_pages.numpy(),
                                  np.asarray(jpool.v_pages))
    np.testing.assert_array_equal(tpool.k_scales.numpy(), jpool.k_scales)
    np.testing.assert_array_equal(tpool.v_scales.numpy(), jpool.v_scales)
    assert tpool.check_invariants()["ok"], tpool.check_invariants()


def test_int8_writes_equal_jax_through_requantize_truncate_and_scrub():
    """A prefill, appends whose amax grows (the page re-quantizes by
    old / new scale), a truncate and appends into the kept tail page:
    the int8 pages and scales are EQUAL to the JAX pool's after every
    step; free, truncate and scrub clear the scales they should."""
    rng = np.random.RandomState(0)
    jpool, tpool = _pool_pair("int8")
    assert tpool.quantized and tpool.k_pages.dtype == torch.int8
    assert tpool.bytes_per_page() == jpool.bytes_per_page()
    for s in (0, 1, 2):
        jpool.allocate(s)
        tpool.allocate(s)
    _write_both(jpool, tpool, [0, 1, 2], [6, 3, 5], rng)       # prefill
    _assert_same_int8(jpool, tpool)
    for gain in (1.5, 3.0, 0.5, 6.0):                          # appends
        _write_both(jpool, tpool, [0, 1, 2], [1, 2, 1], rng, gain)
        _assert_same_int8(jpool, tpool)
    grew = jpool.k_scales[:, jpool._tables[0].pages[0]]
    assert (grew > 0).all()
    freed = tpool._tables[0].pages[2:]
    assert jpool.truncate_seq(0, 5) == tpool.truncate_seq(0, 5) == 1
    _assert_same_int8(jpool, tpool)
    assert (tpool.k_scales[:, freed] == 0).all()
    _write_both(jpool, tpool, [0, 2], [4, 2], rng, 2.0)        # regrow
    _assert_same_int8(jpool, tpool)
    ts = tpool.layer_scales(1)
    np.testing.assert_array_equal(ts[0].numpy(), jpool.layer_scales(1)[0])
    scrubbed = list(tpool._tables[1].pages)
    assert jpool.scrub_seq_pages(1) == tpool.scrub_seq_pages(1)
    _assert_same_int8(jpool, tpool)
    assert (tpool.v_scales[:, scrubbed] == 0).all()
    for s in (0, 1, 2):
        jpool.free_seq(s)
        tpool.free_seq(s)
    _assert_same_int8(jpool, tpool)
    assert not tpool.k_scales.any() and not tpool.v_scales.any()


def test_int8_nan_row_poisons_only_its_page_scale():
    rng = np.random.RandomState(5)
    jpool, tpool = _pool_pair("int8")
    for pool in (jpool, tpool):
        pool.allocate(0)
        pool.allocate(1)
    _write_both(jpool, tpool, [0, 1], [3, 3], rng)
    jp, js = jpool.append_tokens([0, 1], [1, 1])
    tp, ts = tpool.append_tokens([0, 1], [1, 1])
    k = rng.standard_normal((2, 2, 8)).astype(np.float32)
    k[0, 1, 3] = np.nan
    jpool.write_kv(0, jp, js, k, k)
    tpool.write_kv(0, tp, ts, torch.from_numpy(k), torch.from_numpy(k))
    np.testing.assert_array_equal(tpool.k_scales.numpy(), jpool.k_scales)
    assert torch.isnan(tpool.k_scales[0, tp[0]])
    assert torch.isfinite(tpool.k_scales[0, tp[1]])
    tpool.scrub_seq_pages(0)
    tpool.free_seq(0)
    assert tpool.check_invariants()["ok"]


def test_scale_audit_flags_a_stale_scale():
    _, tpool = _pool_pair("int8")
    tpool.allocate(0)
    pages, slots = tpool.append_tokens([0], [5])
    for li in range(2):
        x = torch.ones(5, 2, 8)
        tpool.write_kv(li, pages, slots, x, x)
    assert tpool.check_invariants()["ok"]
    tpool.k_scales[0, tpool._free[-1]] = 1.0  # a free page with a scale
    report = tpool.check_invariants()
    assert not report["ok"] and report["scale_errors"] == [tpool._free[-1]]
    tpool.k_scales[0, tpool._free[-1]] = 0.0
    tpool.k_scales[1, pages[0]] = 0.0  # a written page lost one layer's
    assert tpool.check_invariants()["scale_errors"] == [int(pages[0])]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_truncate_bookkeeping_matches_jax(dtype):
    """truncate_seq interleaved with appends and frees gives the same
    tables, lengths, free list and counters as the JAX pool."""
    jpool, tpool = _pool_pair(dtype, pages=16)
    rng = np.random.RandomState(1)

    def same():
        ids = sorted(tpool._tables)
        if ids:
            for a, b in zip(jpool.page_table_batch(ids),
                            tpool.page_table_batch(ids)):
                np.testing.assert_array_equal(a, b)
        assert jpool._free == tpool._free
        for key in ("tokens_truncated", "page_frees", "page_allocs",
                    "token_appends"):
            assert jpool.stats()[key] == tpool.stats()[key], key
        assert tpool.check_invariants()["ok"]

    for s in (0, 1, 2):
        jpool.allocate(s)
        tpool.allocate(s)
    for _ in range(8):
        ids = [s for s in (0, 1, 2) if s in tpool._tables]
        counts = rng.randint(1, 6, size=len(ids)).tolist()
        _write_both(jpool, tpool, ids, counts, rng)
        same()
        for s in ids:
            n = int(rng.randint(0, tpool.length(s) + 1))
            assert jpool.truncate_seq(s, n) == tpool.truncate_seq(s, n)
        same()
    assert tpool.truncate_seq(0, tpool.length(0)) == 0
    with pytest.raises(ValueError, match="truncate"):
        tpool.truncate_seq(0, tpool.length(0) + 1)
    with pytest.raises(ValueError, match="truncate"):
        tpool.truncate_seq(0, -1)
    for s in (0, 1, 2):
        assert jpool.free_seq(s) == tpool.free_seq(s)
    same()
    assert tpool.stats()["tokens_truncated"] > 0


# -- 5: the drafter -----------------------------------------------------------

def test_prompt_lookup_drafter_cases_match_jax():
    for mod in (jspec, tspec):
        d = mod.PromptLookupDrafter(max_draft=4, max_ngram=3)
        assert d.draft([5, 6, 7, 9, 5, 6, 7]) == [9, 5, 6, 7]
        assert d.draft([1, 2, 3]) == []
        assert d.draft([4, 4, 4, 4]) == [4, 4, 4]
        assert d.draft([5, 6, 7, 9, 5, 6, 7], max_draft=2) == [9, 5]
        assert d.draft([1, 2, 1, 2, 1, 2]) == [1, 2, 1, 2]
        assert d.draft([3]) == [] and d.draft([]) == []
        with pytest.raises(ValueError):
            mod.PromptLookupDrafter(max_draft=0)
        with pytest.raises(ValueError):
            mod.PromptLookupDrafter(min_ngram=3, max_ngram=2)
        with pytest.raises(TypeError):
            mod.PromptLookupDrafter(corpus=object())


@pytest.mark.parametrize("ngrams", [(1, 3), (2, 4)])
def test_drafter_matches_jax_over_random_commit_rollback_histories(ngrams):
    """Stateless and indexed proposals of both packages agree at every
    point of random commit / rollback histories, and the port's index
    re-syncs to exactly the visible context."""
    lo, hi = ngrams
    rng = np.random.RandomState(7)
    for trial in range(6):
        mine = tspec.PromptLookupDrafter(max_draft=4, min_ngram=lo,
                                         max_ngram=hi)
        theirs = jspec.PromptLookupDrafter(max_draft=4, min_ngram=lo,
                                           max_ngram=hi)
        ctx = rng.randint(0, 5, size=rng.randint(2, 8)).tolist()
        for step in range(50):
            if rng.rand() < 0.25 and len(ctx) > 3:
                ctx = ctx[:rng.randint(2, len(ctx))]
            else:
                ctx = ctx + rng.randint(0, 5,
                                        size=rng.randint(1, 4)).tolist()
            limit = int(rng.randint(1, 6))
            want = theirs.draft(ctx, limit, seq_id=trial)
            assert want == theirs.draft(ctx, limit)
            assert mine.draft(ctx, limit, seq_id=trial) == want, (trial,
                                                                 step)
            assert mine.draft(ctx, limit) == want
            assert mine._index[trial].tokens == ctx


def test_drafter_release_lru_and_corpus_hook():
    d = tspec.PromptLookupDrafter(max_draft=2, max_sequences=2)
    assert d.stateful and d.adapter_aware
    for sid in (10, 11, 12):
        d.draft([1, 2, 1, 2], 2, seq_id=sid)
    assert d.tracked_sequences() == 2 and 10 not in d._index
    d.release(11)
    d.release(99)
    assert d.tracked_sequences() == 1

    class Corpus:
        def ngram_continuation(self, probe, limit, adapter_id=None):
            return [7, 8, 9][:limit] if probe[-1] == 3 else []

    for mod in (jspec, tspec):
        c = mod.PromptLookupDrafter(max_draft=3, corpus=Corpus())
        assert c.draft([1, 2, 3]) == [7, 8, 9]
        assert c.last_source == "corpus"
        assert c.draft([1, 2, 1, 2]) == [1, 2]
        assert c.last_source == "own"


# -- 6: verify_step -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_verify_step_matches_jax(dtype):
    """The same prefill on matching pools, then two verify steps with
    ragged blocks (one of length 1): [B, Sq, V] logits agree at every
    valid row, and the pools hold the same pages and tables."""
    jcfg, tcfg = _cfgs(n_kv_head=4)
    params = jgen.init_decode_params(jcfg, seed=3)
    model = tgen.TransformerDecoder(tcfg, device="cpu").load_jax_params(params)
    jpool, tpool = _pools(jcfg, 40, dtype)
    prompts = _prompts(3)[:3]
    ids = [0, 1, 2]
    for s in ids:
        jpool.allocate(s)
        tpool.allocate(s)
    want = jgen.prefill_step(params, jcfg, jpool, ids, prompts, force="jax")
    got = model.prefill_step(tpool, ids, prompts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rng = np.random.RandomState(4)
    starts = np.asarray([len(p) for p in prompts])
    for lens in ([3, 1, 5], [2, 4, 1]):
        blocks = [[int(t) for t in rng.randint(1, 61, size=n)] for n in lens]
        want = jgen.verify_step(params, jcfg, jpool, ids, blocks, starts,
                                impl="reference", pad_to=5)
        got = model.verify_step(tpool, ids, blocks, starts, pad_to=5)
        assert got.shape == (3, 5, CFG["vocab_size"])
        for b, n in enumerate(lens):
            np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n],
                                       **TOL)
        starts = starts + np.asarray(lens)
    assert tpool.page_table_batch(ids)[0].tolist() == \
        jpool.page_table_batch(ids)[0].tolist()
    if dtype == "float32":
        np.testing.assert_allclose(tpool.k_pages.numpy(),
                                   np.asarray(jpool.k_pages), **TOL)


def test_verify_step_refuses_before_claiming():
    _, tcfg = _cfgs()
    model = tgen.TransformerDecoder(tcfg, device="cpu")
    model.load_jax_params(tgen.init_decode_params(tcfg, seed=0))
    _, tpool = _pools(_cfgs()[0], 40)
    tpool.allocate(0)
    model.prefill_step(tpool, [0], [[1, 2, 3]])
    with pytest.raises(ValueError, match="max_length"):
        model.verify_step(tpool, [0], [[1] * 3], [CFG["max_length"] - 2])
    with pytest.raises(ValueError, match="pad_to"):
        model.verify_step(tpool, [0], [[1, 2, 3]], [3], pad_to=2)
    with pytest.raises(ValueError, match=">= 1 fed token"):
        model.verify_step(tpool, [0], [[]], [3])
    assert tpool.length(0) == 3


# -- 7: the loop against the JAX loop -----------------------------------------

def _run_both(d, h_kv, dtype, jimpl="reference"):
    jcfg, tcfg = _cfgs(n_kv_head=h_kv)
    params = jgen.init_decode_params(jcfg, seed=2)
    prompts = _prompts(2)
    jpool, tpool = _pools(jcfg, 48, dtype)
    jloop = jgen.ContinuousBatchingLoop(params, jcfg, jpool, max_batch=3,
                                        paged_impl=jimpl, speculate=d)
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tpool, max_batch=3,
                                        device="cpu", speculate=d)
    jres = jloop.run([jgen.DecodeRequest(p, 10) for p in prompts])
    tres = tloop.run([tgen.DecodeRequest(p, 10) for p in prompts])
    return params, tcfg, prompts, jloop, tloop, jres, tres, tpool


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("h_kv", [8, 4])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_speculative_loop_matches_jax_loop(d, h_kv, dtype):
    params, tcfg, prompts, jloop, tloop, jres, tres, tpool = _run_both(
        d, h_kv, dtype)
    for p, jr, tr in zip(prompts, jres, tres):
        assert tr.error is None and tr.tokens == jr.tokens
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, **TOL)
        if dtype == "float32":
            assert tr.tokens == tgen.full_decode(params, tcfg, p, 10,
                                                 device="cpu")[0]
    for key in ("steps", "spec_steps", "decode_steps", "drafted_tokens",
                "accepted_tokens", "rolled_back_tokens"):
        assert getattr(tloop, key) == getattr(jloop, key), key
    assert tloop.drafted_tokens > 0 and tloop.spec_steps > 0
    assert tloop.acceptance_rate() == jloop.acceptance_rate()
    assert len(tloop.verify_step_s) == tloop.spec_steps
    assert tpool.used_pages == 0 and tpool.check_invariants()["ok"]
    assert tloop.drafter.tracked_sequences() == 0  # released on retire


def test_speculative_loop_matches_jax_pallas_interpret():
    """One case through the JAX Pallas kernel itself (interpret mode)."""
    _, _, _, jloop, tloop, jres, tres, tpool = _run_both(2, 4, "float32",
                                                         jimpl="interpret")
    for jr, tr in zip(jres, tres):
        assert tr.tokens == jr.tokens
        for a, b in zip(tr.logits, jr.logits):
            np.testing.assert_allclose(a, b, **TOL)
    assert tloop.spec_steps == jloop.spec_steps > 0
    assert tpool.check_invariants()["ok"] and tpool.used_pages == 0


# -- 8: the loop's edges ------------------------------------------------------

SMALL = dict(vocab_size=61, d_model=16, n_head=2, n_layer=2, d_inner=32,
             max_length=64)


def _small_pool(cfg, pages=80, dtype="float32"):
    return tkv.KVCachePool(pages, 4, cfg.n_layer, cfg.n_head, cfg.head_dim,
                           device="cpu", dtype=dtype)


def test_rollbacks_occur_stay_clean_and_save_steps():
    cfg = tgen.DecodeConfig(**SMALL)
    params = tgen.init_decode_params(cfg, seed=2)
    prompts = _prompts(2)
    pool = _small_pool(cfg)
    loop = tgen.ContinuousBatchingLoop(params, cfg, pool, max_batch=4,
                                       device="cpu", speculate=3)
    results = loop.run([tgen.DecodeRequest(p, 14) for p in prompts])
    for p, res in zip(prompts, results):
        assert res.tokens == tgen.full_decode(params, cfg, p, 14,
                                              device="cpu")[0]
    assert loop.rolled_back_tokens > 0
    assert loop.accepted_tokens < loop.drafted_tokens
    assert 0.0 < loop.acceptance_rate() < 1.0
    assert pool.stats()["tokens_truncated"] == loop.rolled_back_tokens
    assert pool.used_pages == 0 and pool.check_invariants()["ok"]
    loop0 = tgen.ContinuousBatchingLoop(params, cfg, _small_pool(cfg),
                                        max_batch=4, device="cpu")
    loop0.run([tgen.DecodeRequest(p, 14) for p in prompts])
    assert loop.steps < loop0.steps


class _OracleDrafter:
    """Proposes the exact greedy continuation: every block is accepted, so
    EOS and max_new land inside accepted blocks."""

    def __init__(self, prompt, tokens):
        self.seq = list(prompt) + list(tokens)

    def draft(self, context, max_draft=None):
        n = len(context)
        return self.seq[n:n + (max_draft or 4)]


def _oracle_setup(seed=0, max_new=14):
    cfg = tgen.DecodeConfig(**SMALL)
    params = tgen.init_decode_params(cfg, seed=seed)
    prompt = [int(t) for t in np.random.RandomState(seed).randint(1, 61,
                                                                  size=6)]
    want, _ = tgen.full_decode(params, cfg, prompt, max_new, device="cpu")
    return cfg, params, prompt, want


def test_eos_inside_accepted_block_truncates_result_and_table():
    _, params, prompt, want = _oracle_setup()
    eos = want[4]
    cfg = tgen.DecodeConfig(**SMALL, eos_id=int(eos))
    want_e, _ = tgen.full_decode(params, cfg, prompt, 14, device="cpu")
    assert want_e[-1] == eos and len(want_e) < 14
    pool = _small_pool(cfg, 32)
    loop = tgen.ContinuousBatchingLoop(params, cfg, pool, max_batch=2,
                                       device="cpu", speculate=4,
                                       drafter=_OracleDrafter(prompt, want))
    res = loop.run([tgen.DecodeRequest(prompt, 14)])[0]
    assert res.tokens == want_e
    assert loop.rolled_back_tokens > 0
    assert pool.used_pages == 0 and pool.check_invariants()["ok"]


def test_max_new_inside_blocks_is_honoured():
    cfg, params, prompt, want = _oracle_setup()
    pool = _small_pool(cfg, 64)
    loop = tgen.ContinuousBatchingLoop(params, cfg, pool, max_batch=4,
                                       device="cpu", speculate=4,
                                       drafter=_OracleDrafter(prompt, want))
    res = loop.run([tgen.DecodeRequest(prompt, 14),
                    tgen.DecodeRequest(prompt, 3),
                    tgen.DecodeRequest(prompt, 7)])
    assert [r.tokens for r in res] == [want, want[:3], want[:7]]
    assert loop.accepted_tokens == loop.drafted_tokens > 0
    assert pool.used_pages == 0 and pool.check_invariants()["ok"]


def test_rogue_drafter_is_clamped_to_its_room():
    cfg = tgen.DecodeConfig(vocab_size=31, d_model=16, n_head=2, n_layer=1,
                            d_inner=16, max_length=32)
    params = tgen.init_decode_params(cfg)
    pool = tkv.KVCachePool(16, 4, 1, 2, 8, device="cpu")

    class Rogue:
        def draft(self, context, max_draft=None):
            return [1, 2, 3, 4, 5, 6, 7]

    loop = tgen.ContinuousBatchingLoop(params, cfg, pool, device="cpu",
                                       speculate=2, drafter=Rogue())
    res = loop.run([tgen.DecodeRequest([1, 2, 3], 4)])
    assert res[0].tokens == tgen.full_decode(params, cfg, [1, 2, 3], 4,
                                             device="cpu")[0]
    assert loop.drafted_tokens <= 2 * loop.spec_steps
    assert pool.used_pages == 0


class _PoisoningDecoder(tgen.TransformerDecoder):
    """Plants NaN in one sequence's pages before a given verify step."""

    def __init__(self, cfg, victim, at_call):
        super().__init__(cfg, device="cpu")
        self.victim, self.at_call, self.calls = victim, at_call, 0

    def verify_step(self, pool, seq_ids, *args, **kw):
        self.calls += 1
        if self.calls == self.at_call:
            pages = pool._tables[seq_ids[self.victim]].pages
            if pool.quantized:
                pool.k_scales[:, pages] = float("nan")
            else:
                pool.k_pages[:, :, pages] = float("nan")
        return super().verify_step(pool, seq_ids, *args, **kw)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_nonfinite_verify_row_quarantines_only_its_sequence(dtype):
    cfg = tgen.DecodeConfig(**SMALL)
    params = tgen.init_decode_params(cfg, seed=2)
    reqs = [tgen.DecodeRequest(p, 14) for p in _prompts(2)]
    clean = tgen.ContinuousBatchingLoop(
        params, cfg, _small_pool(cfg, dtype=dtype), max_batch=4,
        device="cpu", speculate=3).run(reqs)
    # the victim holds page 0, which every shorter table pads with
    model = _PoisoningDecoder(cfg, victim=0, at_call=2)
    model.load_jax_params(params)
    pool = _small_pool(cfg, dtype=dtype)
    loop = tgen.ContinuousBatchingLoop(model, cfg, pool, max_batch=4,
                                       device="cpu", speculate=3)
    res = loop.run(reqs)
    assert isinstance(res[0].error, tgen.NonFiniteSequenceError)
    assert loop.quarantined == 1
    assert res[0].tokens == clean[0].tokens[:len(res[0].tokens)]
    for i in (1, 2, 3):
        assert res[i].error is None and res[i].tokens == clean[i].tokens
    assert pool.used_pages == 0 and pool.check_invariants()["ok"]
    if dtype == "int8":
        assert not pool.k_scales.isnan().any()
    assert loop.drafter.tracked_sequences() == 0


def test_negative_speculate_raises():
    cfg = tgen.DecodeConfig(**SMALL)
    with pytest.raises(ValueError, match="speculate"):
        tgen.ContinuousBatchingLoop(tgen.init_decode_params(cfg), cfg,
                                    _small_pool(cfg), device="cpu",
                                    speculate=-1)
