"""The port's sampling (paddle_tpu_torch/serving/sampling.py and
_threefry.py, and the loop's sampled and sampled-speculative arms)
against the JAX package's, on the CPU.  The same numpy inputs, seeds and
``init_decode_params`` weights go to both packages.

Tolerances:
- the stream's words and uniforms: EQUAL to ``jax.random``'s (threefry
  is integer arithmetic; a uniform is the word's top 23 bits);
- Gumbels: 1e-6 absolute (two float32 logs, whose last ulps differ
  between XLA and torch);
- tokens and accepted counts: EQUAL on every row whose decision margin
  (``sampling.decision_margins``: the relative gap of each Gumbel-max
  draw, of each accept uniform to p(draft), and of the top-p boundary
  where moving it changes the outcome) exceeds 1e-5; at most 1% of rows
  may lie inside it.  Float32 rounding differences between the two
  packages are about 1e-7 relative, so only such near-ties can flip.
  The margin excuses a row only where it is small, so a wrong stream
  (the planted fault) still fails;
- the exactness harness on the port's own epilogues: the bounds of
  tests/test_speculative.py (TV < 0.05, the chi-square bound, acceptance
  within 5 sigma of p(draft)).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jsampling = importlib.import_module("paddle_tpu.serving.sampling")

from paddle_tpu_torch import serving as tserving  # noqa: E402
from paddle_tpu_torch.serving import _threefry  # noqa: E402
from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402
from paddle_tpu_torch.serving import sampling as tsampling  # noqa: E402

MARGIN = 1e-5        # relative decision margin under which a draw may flip
NEAR_SHARE = 0.01    # at most this share of rows inside the margin
GUMBEL_TOL = 1e-6


# -- SamplingParams, stop_hit, apply_bias -------------------------------------

PARAM_CASES = [
    dict(stop=[[1, 2]], logit_bias={3: 2.0, 1: -1.0}),
    dict(temperature=-1), dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5),
    dict(max_new=0), dict(stop=[[]]), dict(seed=-1), dict(seed=2 ** 32),
    dict(logit_bias={-2: 1.0}),
]


@pytest.mark.parametrize("kw", PARAM_CASES, ids=str)
def test_sampling_params_match_the_jax_contract(kw):
    """The accepted and refused inputs of tests/test_speculative.py: the
    port refuses what JAX refuses, and normalises what it accepts the
    same way (stop_hit and apply_bias on the accepted one)."""
    try:
        want = jsampling.SamplingParams(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            tsampling.SamplingParams(**kw)
        return
    got = tsampling.SamplingParams(**kw)
    for f in ("temperature", "top_k", "top_p", "stop", "logit_bias",
              "max_new", "seed"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.greedy == want.greedy
    assert got.max_bias_token() == want.max_bias_token() == 3
    assert tsampling.SamplingParams().max_bias_token() == -1
    assert hash(got) is not None
    for toks in ([9, 1, 2], [1, 2, 9], [2], []):
        assert tsampling.stop_hit(toks, got) == jsampling.stop_hit(toks, want)
    row = np.random.RandomState(0).standard_normal(8).astype(np.float32)
    biased = tsampling.apply_bias(row, got)
    np.testing.assert_array_equal(biased, jsampling.apply_bias(row, want))
    assert biased is not row and tsampling.apply_bias(row, None) is row
    # the device rows' bias: the same float32 adds, [R, V] and [R, Sq, V]
    rows = torch.as_tensor(np.stack([row, row + 1]))
    out = tsampling.bias_rows(rows, [got, None])
    np.testing.assert_array_equal(out[0].numpy(), biased)
    np.testing.assert_array_equal(out[1].numpy(), row + 1)
    out3 = tsampling.bias_rows(rows[:, None, :].repeat(1, 3, 1), [None, got])
    for t in range(3):
        np.testing.assert_array_equal(
            out3[1, t].numpy(), jsampling.apply_bias(row + 1, want))


def test_bias_rows_applies_a_repeated_token_in_order():
    p = tsampling.SamplingParams(logit_bias=[(2, 0.1), (2, 1e8), (0, 0.3)])
    row = np.full(4, 0.7, np.float32)
    got = tsampling.bias_rows(torch.as_tensor(row[None]), [p])[0].numpy()
    np.testing.assert_array_equal(got, tsampling.apply_bias(row, p))
    np.testing.assert_array_equal(
        got, jsampling.apply_bias(row, jsampling.SamplingParams(
            logit_bias=[(2, 0.1), (2, 1e8), (0, 0.3)])))


# -- the stream ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456, 2 ** 32 - 1])
def test_threefry_stream_equals_jax_random(seed):
    for g in (0, 3, 99):
        jk = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                np.uint32(g))
        tk = _threefry.fold_in(_threefry.key(torch.tensor(seed)), g)
        np.testing.assert_array_equal(
            tk.numpy(), np.asarray(jax.random.key_data(jk), np.int64))
        for salt in (None, 1, 2):
            jks = jk if salt is None else jax.random.fold_in(jk, salt)
            tks = tk if salt is None else _threefry.fold_in(tk, salt)
            np.testing.assert_array_equal(
                _threefry.bits(tks, 1000).numpy(),
                np.asarray(jax.random.bits(jks, (1000,), jnp.uint32),
                           np.int64))
            assert float(_threefry.uniform(tks, 1)[0]) == float(
                jax.random.uniform(jks, ()))
            np.testing.assert_allclose(
                _threefry.gumbel(tks, 1000).numpy(),
                np.asarray(jax.random.gumbel(jks, (1000,))),
                rtol=0, atol=GUMBEL_TOL)
    # vectorised over rows: [R] keys give [R, n] words in one pass
    keys = _threefry.fold_in(_threefry.key(torch.full((3,), seed)),
                             torch.tensor([0, 3, 99]))
    words = _threefry.bits(keys, 64)
    for r, g in enumerate((0, 3, 99)):
        one = _threefry.fold_in(_threefry.key(torch.tensor(seed)), g)
        np.testing.assert_array_equal(words[r].numpy(),
                                      _threefry.bits(one, 64).numpy())


# -- the epilogues against JAX's ----------------------------------------------

def _jparams(p):
    return jsampling.SamplingParams(
        temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
        stop=p.stop, logit_bias=p.logit_bias, max_new=p.max_new,
        seed=p.seed)


def _mixed(rng, n, V):
    """n sampled params over every knob: temperatures, top-k, top-p
    (with both), seeds over the whole uint32 range."""
    out = []
    for i in range(n):
        kw = dict(temperature=float(rng.choice([0.3, 0.8, 1.0, 1.7])),
                  seed=int(rng.randint(0, 2 ** 32, dtype=np.uint64)))
        if i % 4 in (1, 3):
            kw["top_k"] = int(rng.randint(1, V // 4))
        if i % 4 in (2, 3):
            kw["top_p"] = float(rng.uniform(0.3, 0.99))
        out.append(tsampling.SamplingParams(**kw))
    return out


def _epilogue_inputs(seed=0, B=64, Sq=5, V=257):
    rng = np.random.RandomState(seed)
    params = _mixed(rng, B, V)
    steps = rng.randint(0, 5000, size=B).tolist()
    steps[0] = 2 ** 32 - 2  # g + t wraps past 2^32 inside the block
    logits = (rng.standard_normal((B, Sq, V)) * 3).astype(np.float32)
    drafts = []
    for i in range(B):
        n = int(rng.randint(0, Sq))
        # drafts the model likes (the argmax) and ones it does not
        drafts.append([int(logits[i, t].argmax()) if rng.rand() < 0.7
                       else int(rng.randint(V)) for t in range(n)])
    return params, steps, logits, drafts


def _check_plain(params, steps, rows):
    got = tsampling.sample_rows(torch.as_tensor(rows), params, steps)
    want = jsampling.sample_rows(rows, [_jparams(p) for p in params], steps)
    margin = tsampling.decision_margins(rows, params, steps)
    near = margin <= MARGIN
    bad = np.flatnonzero((got != want) & ~near)
    assert not len(bad), f"rows {bad.tolist()} differ outside the margin"
    return int(near.sum())


def _check_spec(params, steps, logits, drafts):
    """Accepted counts and the emitted walk of every row against JAX's;
    returns the number of rows inside the margin."""
    acc, toks = tsampling.spec_sample_rows(torch.as_tensor(logits), params,
                                           steps, drafts)
    jacc, jtoks = jsampling.spec_sample_rows(
        logits, [_jparams(p) for p in params], steps, drafts)
    margin = tsampling.decision_margins(logits, params, steps, drafts)
    near = margin <= MARGIN
    for i in range(len(params)):
        if near[i]:
            continue
        assert acc[i] == jacc[i], f"row {i}: accepted {acc[i]} vs {jacc[i]}"
        n = int(acc[i]) + 1
        assert (toks[i, :n] == jtoks[i, :n]).all(), f"row {i}"
    return int(near.sum())


def test_sample_rows_matches_jax():
    params, steps, logits, _ = _epilogue_inputs()
    near = _check_plain(params, steps, logits[:, 0])
    assert near <= NEAR_SHARE * len(params), near
    print(f"sample_rows: {near} of {len(params)} rows inside the margin")


def test_spec_sample_rows_matches_jax():
    params, steps, logits, drafts = _epilogue_inputs(seed=1)
    near = _check_spec(params, steps, logits, drafts)
    assert near <= NEAR_SHARE * len(params), near
    print(f"spec_sample_rows: {near} of {len(params)} rows inside the margin")


def test_a_residual_drawn_unsalted_fails_the_gate(monkeypatch):
    """The planted fault: residual Gumbels from key_g itself (unsalted)."""
    params, steps, logits, drafts = _epilogue_inputs(seed=1)
    real = tsampling._salt
    monkeypatch.setattr(
        tsampling, "_salt",
        lambda k, salt: k if salt == tsampling.RESIDUAL_SALT
        else real(k, salt))
    with pytest.raises(AssertionError, match="row"):
        _check_spec(params, steps, logits, drafts)


def test_epilogues_refuse_what_jax_refuses():
    logits = np.zeros((2, 3, 8), np.float32)
    sp = tsampling.SamplingParams(temperature=0.8, seed=0)
    greedy = tsampling.SamplingParams()
    with pytest.raises(ValueError, match="greedy"):
        tsampling.sample_rows(logits[:, 0], [greedy, sp], [0, 0])
    with pytest.raises(ValueError, match="greedy"):
        tsampling.spec_sample_rows(logits, [greedy, sp], [0, 0], [[1], [1]])
    with pytest.raises(ValueError, match="at most"):
        tsampling.spec_sample_rows(logits, [sp, sp], [0, 0], [[1, 2, 3], [1]])
    with pytest.raises(ValueError, match="align"):
        tsampling.sample_rows(logits[:, 0], [sp], [0, 0])
    with pytest.raises(ValueError, match="align"):
        tsampling.spec_sample_rows(logits, [sp, sp], [0, 0], [[1]])
    with pytest.raises(ValueError, match=r"\[B, V\]"):
        tsampling.sample_rows(logits, [sp, sp], [0, 0])
    with pytest.raises(ValueError, match=r"\[B, Sq, V\]"):
        tsampling.spec_sample_rows(logits[:, 0], [sp, sp], [0, 0], [[], []])


def test_epilogue_semantics():
    """Replay, per-step keys, collapse to argmax, the top_p no-op, and an
    undrafted spec row that is exactly sample_rows."""
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((64, 32)).astype(np.float32)
    ps = [tsampling.SamplingParams(temperature=0.8, seed=i) for i in range(64)]
    t1 = tsampling.sample_rows(logits, ps, [0] * 64)
    assert (t1 == tsampling.sample_rows(logits, ps, [0] * 64)).all()
    assert (t1 != tsampling.sample_rows(logits, ps, [1] * 64)).any()
    for collapse in (dict(top_k=1), dict(top_p=1e-7)):
        pc = [tsampling.SamplingParams(temperature=5.0, seed=i, **collapse)
              for i in range(64)]
        assert (tsampling.sample_rows(logits, pc, [0] * 64)
                == logits.argmax(-1)).all()
    hot = [tsampling.SamplingParams(temperature=1.0, seed=i)
           for i in range(64)]
    assert float((tsampling.sample_rows(logits, hot, list(range(64)))
                  == logits.argmax(-1)).mean()) < 0.5
    steps = list(range(64))
    acc, toks = tsampling.spec_sample_rows(logits[:, None, :], ps, steps,
                                           [[]] * 64)
    assert (acc == 0).all()
    assert (toks[:, 0] == tsampling.sample_rows(logits, ps, steps)).all()


# -- exactness of the port's own accept/resample epilogue ---------------------

def _exact_probs(row, p):
    x = tsampling._filter_scaled(
        torch.as_tensor(row[None]), torch.tensor([p.temperature]),
        torch.tensor([p.top_k]), torch.tensor([p.top_p]))[0].double().numpy()
    x = x - x[np.isfinite(x)].max()
    e = np.where(np.isfinite(x), np.exp(x), 0.0)
    return e / e.sum()


@pytest.mark.parametrize("kw", [
    dict(temperature=0.8),
    dict(temperature=0.9, top_k=8),
    dict(temperature=1.0, top_p=0.85),
], ids=["temp", "topk", "topp"])
def test_spec_epilogue_emitted_distribution_is_exact(kw):
    """tests/test_speculative.py's harness on the port: the first token
    the accept/resample walk emits is distributed as the plain sampler's
    (TV), as the exact filtered softmax (chi-square), and acceptance is a
    Bernoulli(p(draft)) draw, over 8192 seeds."""
    V, B = 32, 8192
    row = np.random.RandomState(5).standard_normal(V).astype(np.float32)
    ps = [tsampling.SamplingParams(seed=i, **kw) for i in range(B)]
    steps = [0] * B
    p_exact = _exact_probs(row, ps[0])
    draft = int(np.argsort(p_exact)[-2])  # in the support, not the mode
    spec_logits = np.broadcast_to(row, (B, 2, V)).copy()
    acc, toks = tsampling.spec_sample_rows(spec_logits, ps, steps,
                                           [[draft]] * B)
    emitted = toks[:, 0]
    accepted = acc >= 1
    assert 0 < accepted.sum() < B
    assert (emitted[accepted] == draft).all()
    assert (emitted[~accepted] != draft).all()
    plain = tsampling.sample_rows(np.broadcast_to(row, (B, V)).copy(), ps,
                                  steps)
    h_spec = np.bincount(emitted, minlength=V) / B
    h_plain = np.bincount(plain, minlength=V) / B
    assert 0.5 * np.abs(h_spec - h_plain).sum() < 0.05
    exp = p_exact * B
    keep = exp >= 5
    chi2 = float((((np.bincount(emitted, minlength=V) - exp) ** 2
                   / np.maximum(exp, 1e-9))[keep]).sum())
    dof = int(keep.sum()) - 1
    assert chi2 < dof + 6 * np.sqrt(2 * dof), (chi2, dof)
    p_d = float(p_exact[draft])
    assert abs(float(accepted.mean()) - p_d) \
        < 5 * np.sqrt(p_d * (1 - p_d) / B)
    acc2, toks2 = tsampling.spec_sample_rows(spec_logits, ps, steps,
                                             [[draft]] * B)
    assert (acc2 == acc).all() and (toks2 == toks).all()


# -- the loop against the JAX loop --------------------------------------------

CFG = dict(vocab_size=61, d_model=32, n_head=4, n_layer=2, d_inner=48,
           max_length=48)
MAX_NEW = 8
MOTIF = [5, 17, 29, 41]
PROMPTS = [(MOTIF * 4)[:n] for n in (9, 12, 7, 10, 8)]
STOP = 4  # the request with a stop sequence


def _requests(gen, smp, greedy_tokens):
    """serve_bench's scenarios beside greedy: a greedy request, temp with
    a logit bias, topk with a per-request max_new, topp, and a greedy
    request whose stop sequence is two tokens of its own greedy
    continuation; motif-tiled prompts, so that sampled rows draft."""
    S = smp.SamplingParams
    stop = tuple(greedy_tokens[3:5])
    params = [None, S(temperature=0.8, seed=1, logit_bias={7: 3.0, 5: -2.0}),
              S(temperature=0.8, top_k=20, max_new=3, seed=2),
              S(temperature=0.8, top_p=0.9, seed=3),
              S(stop=[stop, (60, 60)])]
    return [gen.DecodeRequest(p, MAX_NEW, sampling=s)
            for p, s in zip(PROMPTS, params)]


def _loop_margin(row, params, g, jtok, ttok):
    """The smallest margin of any decision that could have split the two
    packages at one emitted token: the plain draw, and the accept and
    residual draws of a draft equal to either package's token."""
    row = tsampling.apply_bias(row, params)
    plain = tsampling.decision_margins(row[None], [params], [g])
    spec = tsampling.decision_margins(np.stack([[row, row]] * 2),
                                      [params] * 2, [g] * 2,
                                      [[jtok], [ttok]])
    return float(min(plain.min(), spec.min()))


def _compare_loops(reqs, jres, tres):
    near = []
    for i, (r, jr, tr) in enumerate(zip(reqs, jres, tres)):
        assert tr.error is None and jr.error is None
        p = r.sampling
        for t, (a, b) in enumerate(zip(tr.tokens, jr.tokens)):
            np.testing.assert_allclose(tr.logits[t], jr.logits[t],
                                       rtol=1e-4, atol=1e-4)
            if a == b:
                continue
            assert p is not None and not p.greedy, (i, t, a, b)
            m = _loop_margin(jr.logits[t], p, t, b, a)
            assert m <= MARGIN, f"request {i} token {t}: {a} vs {b}, {m}"
            near.append((i, t, m))
            break
        else:
            assert len(tr.tokens) == len(jr.tokens), i
    return near


@pytest.mark.parametrize("d,dtype,jimpl", [
    (0, "float32", "interpret"), (2, "float32", "reference"),
    (0, "int8", "reference"), (2, "int8", "reference")])
def test_sampled_loop_matches_jax_loop(d, dtype, jimpl):
    """The JAX loop through its plain paged attention, and once through
    the Pallas kernel itself in interpret mode."""
    jcfg, tcfg = jgen.DecodeConfig(**CFG), tgen.DecodeConfig(**CFG)
    params = jgen.init_decode_params(jcfg, seed=3)
    greedy = tgen.full_decode(params, tcfg, PROMPTS[STOP], MAX_NEW,
                              device="cpu")[0]
    jreqs = _requests(jgen, jsampling, greedy)
    treqs = _requests(tgen, tsampling, greedy)
    kw = dict(num_pages=64, page_size=4, num_layers=tcfg.n_layer,
              num_heads=tcfg.n_head, head_dim=tcfg.head_dim, dtype=dtype)
    jpool, tpool = jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)
    jloop = jgen.ContinuousBatchingLoop(params, jcfg, jpool, max_batch=4,
                                        paged_impl=jimpl, speculate=d)
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tpool, max_batch=4,
                                        device="cpu", speculate=d)
    jres, tres = jloop.run(jreqs), tloop.run(treqs)
    near = _compare_loops(treqs, jres, tres)
    assert len(near) <= NEAR_SHARE * sum(len(r.tokens) for r in jres), near
    if not near:
        for key in ("steps", "spec_steps", "drafted_tokens",
                    "accepted_tokens", "rolled_back_tokens"):
            assert getattr(tloop, key) == getattr(jloop, key), key
    if d:
        assert tloop.drafted_tokens > 0 and tloop.rolled_back_tokens > 0
    assert tloop.epilogue_s  # every sampled step timed its epilogue call
    # the edges: the stop sequence retires its request inside the cap,
    # max_new caps one, greedy rows are full_decode's
    stop_req = tres[STOP]
    assert 2 <= len(stop_req.tokens) < MAX_NEW
    assert tuple(stop_req.tokens[-2:]) == treqs[STOP].sampling.stop[0]
    assert len(tres[2].tokens) == 3
    if dtype == "float32":
        for i in (0, STOP):
            want = tgen.full_decode(params, tcfg, treqs[i].prompt, MAX_NEW,
                                    device="cpu")[0]
            assert tres[i].tokens == want[:len(tres[i].tokens)]
    assert tpool.used_pages == 0 and tpool.check_invariants()["ok"]


def test_sampled_first_tokens_after_chunked_prefill_match_whole_prefill():
    """The first token after a chunked (and a prefix-cached) prefill goes
    through the same epilogue call at g = 0: the same tokens as the
    whole-prompt prefill, outside the margin."""
    cfg = tgen.DecodeConfig(**CFG)
    params = tgen.init_decode_params(cfg, seed=3)
    greedy = tgen.full_decode(params, cfg, PROMPTS[STOP], MAX_NEW,
                              device="cpu")[0]
    reqs = _requests(tgen, tsampling, greedy)
    runs = []
    for kw in ({}, dict(prefill_chunk=4), dict(prefill_chunk=4, cache=True)):
        pool = tkv.KVCachePool(64, 4, cfg.n_layer, cfg.n_head, cfg.head_dim,
                               device="cpu")
        cache = tserving.PrefixCache(pool) if kw.pop("cache", False) else None
        loop = tgen.ContinuousBatchingLoop(params, cfg, pool, max_batch=4,
                                           device="cpu", speculate=2,
                                           prefix_cache=cache, **kw)
        runs.append(loop.run(reqs + reqs[:2]))
        if cache is not None:
            assert loop.prefix_hits > 0
            cache.clear()
        assert pool.used_pages == 0 and pool.check_invariants()["ok"]
    for other in runs[1:]:
        near = _compare_loops(reqs + reqs[:2], runs[0], other)
        assert len(near) <= NEAR_SHARE * sum(len(r.tokens) for r in other)


def test_out_of_vocab_bias_raises_before_any_work():
    cfg = tgen.DecodeConfig(**CFG)
    pool = tkv.KVCachePool(16, 4, cfg.n_layer, cfg.n_head, cfg.head_dim,
                           device="cpu")
    loop = tgen.ContinuousBatchingLoop(tgen.init_decode_params(cfg), cfg,
                                       pool, device="cpu")
    bad = tserving.SamplingParams(temperature=0.8, logit_bias={61: 1.0})
    with pytest.raises(ValueError, match="vocab_size"):
        loop.run([tserving.DecodeRequest([1, 2], 4),
                  tserving.DecodeRequest([1, 2], 4, sampling=bad)])
    assert pool.free_pages == pool.num_pages and loop.steps == 0
