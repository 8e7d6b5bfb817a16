"""The arithmetic of the paged kernel's cluster split, on the CPU.

``paddle_tpu_torch/kernels/csrc/paged_decode.cu`` splits each sequence's
walk over its live table entries across a cluster of S blocks: in rounds
of S * PPR whole pages, rank i takes pages [(round * S + i) * PPR, + PPR).
Each rank is handed M_in, the max over the earlier rounds and the lower
ranks' pages, so its running max m_k after each of its pages is the
serial walk's own; it weights a key of page k with bf16(exp(s - m_k)) *
exp(m_k - M_end) and adds exp(s - m_k) * exp(m_k - M_end) to l, where
M_end is the max over the whole cluster; a later round rescales by
exp(M_old - M_new), and the ranks' partials are summed in rank order.

``split_model`` below is a plain model of exactly that, written here and
nowhere else.  It is held, at S in {1, 2, 3, 8}, against the port's
serial plain version ``paged_bf16_reference`` and against the JAX Pallas
kernel in interpret mode on bf16 pools, on the walks and cases of
test_torch_bf16_pool.py and on contexts of 75 and 43 pages, under that
file's gate: within 2^-7 * max |reference| and at most 1% of the
elements not bit-equal, over the rows a step reads.  Only fp32 sums and
exp arguments move between the split and the serial walk (fp32 ulps); the
bf16 rounding points do not.

The naive split, where each range starts from its own max instead of
M_in, rounds p against another max: it must FAIL the gate on the long
cases.  That is what the handed-in prefix max is for.

The same model without rounding (fp32 pools, q unrounded) is held against
``paged_windowed_reference`` within 1e-5.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")

from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402

BF16_ULP = 2.0 ** -7
MISMATCH_SHARE = 0.01
FP32_TOL = 1e-5
NEG_INF = -1e30
CLUSTERS = (1, 2, 3, 8)


def split_model(q, k_pages, v_pages, page_tables, lengths, q_lengths=None,
                page_starts=None, windows=None, sinks=None, *, S,
                ppr_cap=None, naive=False, rounding=True):
    """The cluster split of the paged kernel, in plain torch: q [B, H_q,
    Sq, D] fp32, pools [H_kv, P, ps, D] (bf16 with ``rounding``, else
    fp32), a flat table (with optional starts) or a TwoLevelTables.
    ``ppr_cap`` caps the pages a rank takes per round (more rounds);
    ``naive`` starts every range from its own max."""
    B, Hq, Sq, D = q.shape
    Hkv, _, ps, _ = k_pages.shape
    G = Hq // Hkv
    R = G * Sq
    scale = 1.0 / math.sqrt(D)
    flat = (page_starts is None and windows is None
            and not isinstance(page_tables, tpaged.TwoLevelTables))
    if isinstance(page_tables, tpaged.TwoLevelTables):
        page_tables, page_starts = page_tables.flatten()
    tables = torch.as_tensor(page_tables).to(torch.long)
    width = tables.shape[1]
    st = (torch.arange(width)[None, :].expand(B, width) * ps
          if page_starts is None
          else torch.as_tensor(page_starts).to(torch.long))
    ln = torch.as_tensor(lengths).to(torch.long).reshape(-1)
    ql = (torch.full((B,), Sq) if q_lengths is None
          else torch.as_tensor(q_lengths).to(torch.long).reshape(-1))
    pstart = st.repeat_interleave(ps, dim=1)
    kpos = pstart + torch.arange(ps).repeat(width)[None, :]
    dead = ((kpos >= ln[:, None])
            | (pstart == tpaged.PAD_START))[:, None, :, None]
    k = tpaged.gather_kv_pages(k_pages, tables).float().masked_fill(dead, 0.0)
    v = tpaged.gather_kv_pages(v_pages, tables).float().masked_fill(dead, 0.0)
    qr = (q.to(torch.bfloat16).float() if rounding else q.float()).reshape(
        B, Hkv, R, D)
    qpos = (ln - ql)[:, None] + (torch.arange(R) % Sq)[None, :]
    kp, sp, qp = kpos[:, None, :], pstart[:, None, :], qpos[:, :, None]
    vis = (kp <= qp) & (kp < ln[:, None, None])
    if windows is not None:
        win = torch.as_tensor(windows).to(torch.long).reshape(-1)
        snk = (torch.zeros_like(win) if sinks is None
               else torch.as_tensor(sinks).to(torch.long).reshape(-1))
        vis = vis & ((sp < snk[:, None, None])
                     | (sp + ps > qp + 1 - win[:, None, None]))
    s_all = (torch.matmul(qr, k.transpose(-1, -2)) * scale).masked_fill(
        ~vis[:, None], NEG_INF)  # [B, H_kv, R, slots]
    out = torch.zeros(B, Hkv, R, D)
    for b in range(B):
        L = int(ln[b])
        if flat:
            n_live = -(-min(L, width * ps) // ps)
        else:
            live = (st[b] < L).nonzero()
            n_live = int(live[-1]) + 1 if len(live) else 0
        ppr = -(-n_live // S) if n_live else 0
        if ppr_cap:
            ppr = min(ppr, ppr_cap)
        rounds = -(-n_live // (S * ppr)) if n_live else 0
        m_ref = torch.full((Hkv, R, 1), NEG_INF / 2)
        acc = torch.zeros(S, Hkv, R, D)
        l = torch.zeros(S, Hkv, R, 1)
        for rd in range(rounds):
            ranges, rank_max = [], []
            for i in range(S):
                e0 = (rd * S + i) * ppr
                pages = range(e0, max(e0, min(e0 + ppr, n_live)))
                ranges.append(pages)
                mx = torch.full((Hkv, R, 1), NEG_INF)
                for e in pages:
                    mx = torch.maximum(mx, s_all[b, :, :, e * ps:(e + 1) * ps]
                                       .amax(-1, keepdim=True))
                rank_max.append(mx)
            m_end = m_ref
            for mx in rank_max:
                m_end = torch.maximum(m_end, mx)
            fac = torch.exp(m_ref - m_end)
            acc, l = acc * fac, l * fac
            for i, pages in enumerate(ranges):
                m = m_ref if not naive else torch.full((Hkv, R, 1),
                                                       NEG_INF / 2)
                if not naive:
                    for mx in rank_max[:i]:
                        m = torch.maximum(m, mx)
                for e in pages:
                    sl = slice(e * ps, (e + 1) * ps)
                    s = s_all[b, :, :, sl]
                    m = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.exp(s - m)
                    ek = torch.exp(m - m_end)
                    w = (p.to(torch.bfloat16).float() if rounding else p) * ek
                    acc[i] += torch.matmul(w, v[b, :, sl])
                    l[i] += (p * ek).sum(-1, keepdim=True)
            m_ref = m_end
        tot_acc = torch.zeros(Hkv, R, D)
        tot_l = torch.zeros(Hkv, R, 1)
        for i in range(S):  # rank order
            tot_acc = tot_acc + acc[i]
            tot_l = tot_l + l[i]
        out[b] = tot_acc / tot_l.clamp_min(1e-30)
    if rounding:
        out = out.to(torch.bfloat16).float()
    return out.reshape(B, Hq, Sq, D)


def _gate(got, want, rows):
    """(max abs err, bound, share not bit-equal, ok) over the valid rows."""
    m = np.broadcast_to(rows, got.shape)
    g, w = got[m], want[m]
    err = float(np.abs(g - w).max())
    bound = BF16_ULP * float(np.abs(w).max())
    share = float((g != w).mean())
    return err, bound, share, err <= bound and share <= MISMATCH_SHARE


def _pools(ps, Hq, Hkv, D, lengths, rng, dtype, window=None, sinks=None):
    """A JAX and a port pool (one layer) filled with the same fp32 rows;
    with windows, each windowed row is evicted before its last 3 tokens,
    as the loop evicts before a step's appends."""
    pages = sum(-(-n // ps) for n in lengths) + 4
    kw = dict(num_pages=pages, page_size=ps, num_layers=1, num_heads=Hq,
              head_dim=D, num_kv_heads=Hkv, dtype=dtype)
    jp, tp = jkv.KVCachePool(**kw), tkv.KVCachePool(device="cpu", **kw)
    ids = list(range(len(lengths)))
    for s in ids:
        jp.allocate(s)
        tp.allocate(s)

    def fill(counts):
        jpg, jsl = jp.append_tokens(ids, counts)
        tpg, tsl = tp.append_tokens(ids, counts)
        k = rng.standard_normal((len(jpg), Hkv, D)).astype(np.float32)
        v = rng.standard_normal((len(jpg), Hkv, D)).astype(np.float32)
        jp.write_kv(0, jpg, jsl, jnp.asarray(k), jnp.asarray(v))
        tp.write_kv(0, tpg, tsl, torch.from_numpy(k), torch.from_numpy(v))

    fill([n - 3 for n in lengths])
    if window is not None:
        for s, w, k in zip(ids, window, sinks):
            if w < tpaged.PAD_START:
                jp.evict_interior(s, w, k)
                tp.evict_interior(s, w, k)
    fill([3] * len(lengths))
    return jp, tp, ids


def _walk(walk, jp, tp, ids, windows, sinks):
    """(JAX tables, JAX lengths, JAX keywords, port tables, port lengths,
    port keywords) of one walk over the pools' sequences."""
    jkw, tkw = {}, {}
    if walk == "two_level":
        jt, jl = jp.two_level_tables(ids, 2)
        tt, tl = tp.two_level_tables(ids, 2)
    elif walk == "starts_window":
        jt, st, jl = jp.page_tables_with_starts(ids)
        tt, tst, tl = tp.page_tables_with_starts(ids)
        jkw["page_starts"], tkw["page_starts"] = jnp.asarray(st), tst
    else:
        jt, jl = jp.page_table_batch(ids)
        tt, tl = tp.page_table_batch(ids)
    if walk in ("starts_window", "two_level"):
        jkw.update(windows=jnp.asarray(windows), sinks=jnp.asarray(sinks))
        tkw.update(windows=windows, sinks=sinks)
    return jt, jl, jkw, tt, tl, tkw


# test_torch_bf16_pool.py's cases, and two long contexts: 75 and 43 pages
# of 4 slots (300 and 170 tokens) beside short rows
LENS = [37, 5, 22, 14]
QLENS = np.array([3, 1, 3, 2], np.int32)
WINDOWS = np.array([8, tpaged.PAD_START, 1, 6], np.int32)
SINKS = np.array([4, 0, 0, 2], np.int32)
LONG_LENS = [300, 5, 170, 41]
LONG_WINDOWS = np.array([tpaged.PAD_START, tpaged.PAD_START, 64, 9], np.int32)
LONG_SINKS = np.array([0, 0, 8, 2], np.int32)
CASES = ([("short", walk, G, ps) for walk in ("decode", "verify",
                                              "starts_window", "two_level")
          for G in (1, 2) for ps in (4, 16)]
         + [("long", walk, 2, 4) for walk in ("decode", "verify",
                                              "starts_window", "two_level")])


def _case(size, walk, G, ps, dtype, seed):
    rng = np.random.RandomState(seed)
    Hkv, D = 2, 16
    lens, win, snk = ((LENS, WINDOWS, SINKS) if size == "short"
                      else (LONG_LENS, LONG_WINDOWS, LONG_SINKS))
    windowed = walk in ("starts_window", "two_level")
    jp, tp, ids = _pools(ps, G * Hkv, Hkv, D, lens, rng, dtype,
                         *((win, snk) if windowed else ()))
    sq = 1 if walk in ("decode", "two_level") else 3
    q = rng.standard_normal((len(lens), G * Hkv, sq, D)).astype(np.float32)
    ql = QLENS if sq > 1 else None
    rows = (np.ones((len(lens), 1, 1, 1), bool) if sq == 1 else
            (np.arange(sq)[None, :] < QLENS[:, None])[:, None, :, None])
    return jp, tp, ids, q, ql, rows, _walk(walk, jp, tp, ids, win, snk)


def _port_kw(tp, q, ql, tt, tl, tkw):
    return dict(q=torch.from_numpy(q), k_pages=tp.k_pages[0],
                v_pages=tp.v_pages[0], page_tables=tt, lengths=tl,
                q_lengths=None if ql is None else torch.from_numpy(ql),
                page_starts=tkw.get("page_starts"),
                windows=tkw.get("windows"), sinks=tkw.get("sinks"))


@pytest.mark.parametrize("size,walk,G,ps", CASES)
def test_split_matches_the_serial_walk_and_the_interpret_kernel(size, walk,
                                                                G, ps):
    jp, tp, ids, q, ql, rows, (jt, jl, jkw, tt, tl, tkw) = _case(
        size, walk, G, ps, "bfloat16", G * 100 + ps)
    want_jax = np.asarray(jpaged.paged_decode_attention(
        jnp.asarray(q), jp.k_pages[0], jp.v_pages[0], jt, jnp.asarray(jl),
        impl="interpret", q_lengths=None if ql is None else jnp.asarray(ql),
        **jkw))
    kw = _port_kw(tp, q, ql, tt, tl, tkw)
    want = tpaged.paged_bf16_reference(**kw).numpy()
    for S in CLUSTERS:
        got = split_model(**kw, S=S).numpy()
        for ref in (want, want_jax):
            err, bound, share, ok = _gate(got, ref, rows)
            assert ok, (S, err, bound, share)
    # rounds: at most 3 pages a rank per round
    got = split_model(**kw, S=2, ppr_cap=3).numpy()
    assert _gate(got, want, rows)[3]


@pytest.mark.parametrize("walk", ["decode", "verify", "starts_window",
                                  "two_level"])
def test_naive_split_fails_the_gate_on_long_contexts(walk):
    """Each range from its own max: p rounds against another max, and
    the bf16 gate must refuse it, where the prefix max passes."""
    _, tp, _, q, ql, rows, (_, _, _, tt, tl, tkw) = _case(
        "long", walk, 2, 4, "bfloat16", 7)
    kw = _port_kw(tp, q, ql, tt, tl, tkw)
    want = tpaged.paged_bf16_reference(**kw).numpy()
    for S in (2, 3, 8):
        assert _gate(split_model(**kw, S=S).numpy(), want, rows)[3]
        err, bound, share, ok = _gate(
            split_model(**kw, S=S, naive=True).numpy(), want, rows)
        assert not ok, (S, err, bound, share)


@pytest.mark.parametrize("size,walk,G,ps", CASES)
def test_fp32_split_matches_the_windowed_reference(size, walk, G, ps):
    _, tp, _, q, ql, rows, (_, _, _, tt, tl, tkw) = _case(
        size, walk, G, ps, "float32", G * 10 + ps)
    kw = _port_kw(tp, q, ql, tt, tl, tkw)
    want = tpaged.paged_windowed_reference(**kw).numpy()
    m = np.broadcast_to(rows, want.shape)
    for S in CLUSTERS:
        got = split_model(**kw, S=S, rounding=False).numpy()
        np.testing.assert_allclose(got[m], want[m], rtol=FP32_TOL,
                                   atol=FP32_TOL)


def test_cluster_size_fills_the_card_once():
    """The wrapper's S: one block an SM (132 on an H100), ranks of at
    least 256 table slots, powers of two up to CLUSTER_MAX."""
    # 8 sequences x 8 KV heads: 255 and 34 pages split in two, serving
    # lengths (11 pages) not at all
    assert tpaged.cluster_size(255, 16, 64) == 2
    assert tpaged.cluster_size(34, 16, 64) == 2
    assert tpaged.cluster_size(11, 16, 64) == 1
    # few heads over a long context: up to the largest cluster
    assert tpaged.cluster_size(256, 16, 16) == 8
    assert tpaged.cluster_size(4096, 16, 1) == tpaged.CLUSTER_MAX
    # a full grid is not split
    assert tpaged.cluster_size(255, 16, 132) == 1
    assert tpaged.cluster_size(0, 16, 1) == 1


def test_cluster_for_counts_row_tiles_and_table_views():
    rng = np.random.RandomState(0)
    q = torch.zeros(8, 8, 1, 64)
    pool = torch.zeros(8, 300, 16, 64)
    tables = rng.randint(0, 300, (8, 34)).astype(np.int32)
    assert tpaged.cluster_for(q, pool, tables) == 2
    # G * Sq * D = 8 * 5 * 128 outputs a KV head: five row tiles
    q5 = torch.zeros(8, 16, 5, 128)
    pool2 = torch.zeros(2, 300, 16, 128)
    assert tpaged.cluster_for(q5, pool2, tables) == tpaged.cluster_size(
        34, 16, 8 * 2 * 5)
    # a two-level view is as wide as its directory: the flat width rounded
    # up to whole blocks, the same S here
    tl = tpaged.TwoLevelTables(np.zeros((8, 3), np.int32),
                               np.zeros((24, 16), np.int32),
                               np.zeros((24, 16), np.int32), 16)
    assert tpaged.cluster_for(q, pool, tl) == 2


@pytest.mark.parametrize("S", [0, tpaged.CLUSTER_MAX + 1])
def test_forced_cluster_size_out_of_range_raises(S):
    q = torch.zeros(1, 2, 1, 8)
    pages = torch.zeros(2, 3, 4, 8)
    with pytest.raises(ValueError, match="_cluster"):
        tpaged.paged_decode_attention(q, pages, pages,
                                      np.zeros((1, 1), np.int32),
                                      np.ones(1, np.int32), _cluster=S)
