"""The port's serving slice (paddle_tpu_torch/serving) against the JAX
package's, on the CPU: the same numpy weights (one init_decode_params
seed, carried across by params_from_jax) and the same requests go
through both.

Tolerances: logits are O(1-10) and both sides run float32 matmuls and
softmaxes in different summation orders (XLA's CPU dot against torch's
CPU matmul) through a 2-layer post-norm stack, which leaves differences
around 1e-6; atol/rtol 1e-4 gives two orders of magnitude of room and
still catches any wrong mask, position or page, which moves logits by
O(0.1).  Generated tokens must be identical.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jgen = importlib.import_module("paddle_tpu.serving.generate")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")

from paddle_tpu_torch import device as tdevice  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import generate as tgen  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(vocab_size=96, d_model=64, n_head=4, n_layer=2, d_inner=128,
           max_length=40)
PAGE = 4


def _cfgs(**over):
    kw = dict(CFG, **over)
    return jgen.DecodeConfig(**kw), tgen.DecodeConfig(**kw)


def _pools(cfg, num_pages):
    kw = dict(num_pages=num_pages, page_size=PAGE, num_layers=cfg.n_layer,
              num_heads=cfg.n_head, head_dim=cfg.head_dim,
              num_kv_heads=cfg.num_kv_heads)
    return jkv.KVCachePool(**kw), tkv.KVCachePool(**kw, device="cpu")


def _requests(seed=0):
    rng = np.random.RandomState(seed)
    shape = [(5, 6), (9, 3), (1, 7), (12, 5), (3, 8), (7, 2), (4, 4)]
    return [(list(rng.randint(1, CFG["vocab_size"], size=n)), m)
            for n, m in shape]


def test_init_decode_params_identical_across_packages():
    jcfg, tcfg = _cfgs(n_kv_head=2)
    jp, tp = jgen.init_decode_params(jcfg, 5), tgen.init_decode_params(tcfg, 5)
    np.testing.assert_array_equal(jp["embed"], tp["embed"])
    np.testing.assert_array_equal(jp["pos"], tp["pos"])
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert jl.keys() == tl.keys()
        for k in jl:
            np.testing.assert_array_equal(jl[k], tl[k])
    st = tgen.params_from_jax(jp, device="cpu")
    assert st["layers"][1]["wk"].dtype == torch.float32
    np.testing.assert_array_equal(st["layers"][1]["wk"].numpy(),
                                  jp["layers"][1]["wk"])


@pytest.mark.parametrize("n_kv_head", [None, 2])
def test_prefill_and_decode_steps_match_jax(n_kv_head):
    """prefill_step then three decode_steps, on matching pools: logits
    agree, and the pools hold the same K/V in the same pages."""
    jcfg, tcfg = _cfgs(n_kv_head=n_kv_head)
    params = jgen.init_decode_params(jcfg, seed=1)
    model = tgen.TransformerDecoder(tcfg, device="cpu").load_jax_params(params)
    jpool, tpool = _pools(jcfg, 24)
    prompts = [p for p, _ in _requests(1)[:3]]
    ids = [0, 1, 2]
    for s in ids:
        jpool.allocate(s)
        tpool.allocate(s)
    want = jgen.prefill_step(params, jcfg, jpool, ids, prompts, force="jax")
    got = model.prefill_step(tpool, ids, prompts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    toks = np.asarray(want).argmax(-1)
    pos = np.asarray([len(p) for p in prompts])
    for _ in range(3):
        want = jgen.decode_step(params, jcfg, jpool, ids, toks, pos,
                                impl="reference")
        got = model.decode_step(tpool, ids, toks, pos)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        toks, pos = np.asarray(want).argmax(-1), pos + 1
    np.testing.assert_allclose(tpool.k_pages.numpy(),
                               np.asarray(jpool.k_pages), **TOL)
    np.testing.assert_allclose(tpool.v_pages.numpy(),
                               np.asarray(jpool.v_pages), **TOL)
    assert tpool.page_table_batch(ids)[0].tolist() == \
        jpool.page_table_batch(ids)[0].tolist()


def test_continuous_batching_matches_jax_loop_and_full_decode():
    """7 mixed-length requests through max_batch=3 on a pool that holds
    fewer worst-case reservations than the batch: admission happens while
    sequences retire (on eos and on max_new).  Tokens are identical to the
    JAX loop and to full_decode; logits agree; no page leaks."""
    reqs = _requests(0)
    # eos: the first token the oracle generates for request 1, so that
    # sequence (and any other emitting it) retires on eos
    probe_cfg = tgen.DecodeConfig(**CFG)
    params = jgen.init_decode_params(jgen.DecodeConfig(**CFG), seed=2)
    eos = tgen.full_decode(params, probe_cfg, reqs[1][0], 1,
                           device="cpu")[0][0]
    jcfg, tcfg = _cfgs(eos_id=eos)
    jpool, tpool = _pools(jcfg, 10)  # 2-3 worst cases at once, not 3 always
    jloop = jgen.ContinuousBatchingLoop(params, jcfg, jpool, max_batch=3,
                                        paged_impl="reference")
    tloop = tgen.ContinuousBatchingLoop(params, tcfg, tpool, max_batch=3,
                                        device="cpu")
    jres = jloop.run([jgen.DecodeRequest(prompt=p, max_new_tokens=m)
                      for p, m in reqs])
    tres = tloop.run([tgen.DecodeRequest(prompt=p, max_new_tokens=m)
                      for p, m in reqs])
    assert (tloop.prefill_steps, tloop.decode_steps, tloop.steps) == \
        (jloop.prefill_steps, jloop.decode_steps, jloop.steps)
    assert tloop.prefill_steps > 1  # admission happened more than once
    assert any(len(r.tokens) < m for r, (_, m) in zip(tres, reqs))  # eos
    for (prompt, m), jr, tr in zip(reqs, jres, tres):
        assert tr.error is None
        assert tr.seq_id == jr.seq_id
        assert tr.tokens == jr.tokens
        oracle_toks, oracle_rows = tgen.full_decode(params, tcfg, prompt, m,
                                                    device="cpu")
        assert tr.tokens == oracle_toks
        for a, b, c in zip(tr.logits, jr.logits, oracle_rows):
            np.testing.assert_allclose(a, b, **TOL)
            np.testing.assert_allclose(a, c, **TOL)
    report = tpool.check_invariants()
    assert report["ok"], report
    assert tpool.used_pages == 0 and tpool.stats()["live_sequences"] == 0
    assert tpool.stats()["used_pages_high_water"] <= tpool.num_pages


def test_full_forward_matches_jax_oracle():
    jcfg, tcfg = _cfgs(n_kv_head=2)
    params = jgen.init_decode_params(jcfg, seed=4)
    toks = _requests(4)[3][0]
    np.testing.assert_allclose(
        tgen.full_forward(params, tcfg, toks, device="cpu"),
        jgen.full_forward(params, jcfg, toks), **TOL)


class _PoisonedDecoder(tgen.TransformerDecoder):
    """Makes one row of one decode step's logits NaN."""

    def __init__(self, cfg, row, at_step):
        super().__init__(cfg, device="cpu")
        self.row, self.at_step, self.calls = row, at_step, 0

    def decode_step(self, *args):
        logits = super().decode_step(*args).clone()
        self.calls += 1
        if self.calls == self.at_step:
            logits[self.row] = float("nan")
        return logits


class _FailingDecoder(tgen.TransformerDecoder):
    def decode_step(self, *args):
        raise RuntimeError("device lost")


def test_non_finite_row_quarantines_only_its_sequence():
    tcfg = tgen.DecodeConfig(**CFG)
    params = tgen.init_decode_params(tcfg, seed=3)
    reqs = [tgen.DecodeRequest(prompt=p, max_new_tokens=m)
            for p, m in _requests(3)[:4]]
    clean_pool = tkv.KVCachePool(16, PAGE, 2, 4, 16, device="cpu")
    clean = tgen.ContinuousBatchingLoop(params, tcfg, clean_pool, max_batch=4,
                                        device="cpu").run(reqs)
    model = _PoisonedDecoder(tcfg, row=1, at_step=1).load_jax_params(params)
    pool = tkv.KVCachePool(16, PAGE, 2, 4, 16, device="cpu")
    loop = tgen.ContinuousBatchingLoop(model, tcfg, pool, max_batch=4,
                                       device="cpu")
    res = loop.run(reqs)
    assert isinstance(res[1].error, tgen.NonFiniteSequenceError)
    assert res[1].tokens == clean[1].tokens[:1]  # the prefill token only
    assert loop.quarantined == 1
    for i in (0, 2, 3):
        assert res[i].error is None and res[i].tokens == clean[i].tokens
    assert pool.check_invariants()["ok"] and pool.used_pages == 0


def test_step_exception_frees_every_stepping_sequence():
    tcfg = tgen.DecodeConfig(**CFG)
    model = _FailingDecoder(tcfg, device="cpu")
    model.load_jax_params(tgen.init_decode_params(tcfg, seed=0))
    pool = tkv.KVCachePool(16, PAGE, 2, 4, 16, device="cpu")
    loop = tgen.ContinuousBatchingLoop(model, tcfg, pool, max_batch=2,
                                       device="cpu")
    with pytest.raises(RuntimeError, match="device lost"):
        loop.run([tgen.DecodeRequest(prompt=p, max_new_tokens=m)
                  for p, m in _requests(5)[:3]])
    assert pool.used_pages == 0 and pool.check_invariants()["ok"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_pool_accounting_and_atomic_exhaustion(pkg):
    """The JAX pool tests' sequences, on each package's pool: same
    accounting, and an exhausted append changes no table."""
    mod = jkv if pkg == "jax" else tkv
    extra = {} if pkg == "jax" else {"device": "cpu"}
    pool = mod.KVCachePool(num_pages=4, page_size=2, num_layers=1,
                           num_heads=1, head_dim=4, **extra)
    pool.allocate(0)
    for step in range(4):  # 4 tokens -> 2 pages
        pages, slots = pool.append_token([0])
        k = np.full((1, 1, 4), step, np.float32)
        if pkg == "torch":
            k = torch.from_numpy(k)
        pool.write_kv(0, pages, slots, k, -k)
    assert pool.used_pages == 2 and pool.length(0) == 4
    assert pool.bytes_per_page() == 2 * 1 * 2 * 1 * 4 * 4
    assert pool.pages_needed(5, 2) == 3
    assert pool.free_seq(0) == 2
    st = pool.stats()
    assert st["page_allocs"] == 2 and st["page_frees"] == 2
    assert st["used_pages_high_water"] == 2 and st["used_pages"] == 0

    pool = mod.KVCachePool(num_pages=2, page_size=2, num_layers=1,
                           num_heads=1, head_dim=4, **extra)
    pool.allocate(0)
    pool.allocate(1)
    pool.append_token([0])
    pool.append_token([1])
    pool.append_token([0])
    with pytest.raises(mod.PagePoolExhausted):
        pool.append_token([0, 1])  # 0 needs a page, none free
    assert pool.length(0) == 2 and pool.length(1) == 1
    with pytest.raises(mod.PagePoolExhausted):
        pool.append_tokens([1, 0], [1, 1])
    assert pool.length(0) == 2 and pool.length(1) == 1
    assert pool.check_invariants()["ok"]


def test_check_invariants_flags_a_leaked_page():
    pool = tkv.KVCachePool(4, 2, 1, 1, 4, device="cpu")
    pool.allocate(0)
    pool.append_tokens([0], [3])
    assert pool.check_invariants()["ok"]
    pool._free.pop()  # a page owned by nobody and not free
    report = pool.check_invariants()
    assert not report["ok"] and len(report["orphaned_pages"]) == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_invalid_decode_config_fails_the_same_way(pkg):
    mod = jgen if pkg == "jax" else tgen
    grouped = jpaged.GroupedHeadsError if pkg == "jax" \
        else tpaged.GroupedHeadsError
    bad_width = mod.DecodeConfig(d_model=30, n_head=4)
    with pytest.raises(ValueError, match="divide by n_head"):
        bad_width.head_dim
    with pytest.raises(ValueError, match="divide by n_head"):
        mod.init_decode_params(bad_width)
    bad_group = mod.DecodeConfig(n_head=4, n_kv_head=3)
    with pytest.raises(grouped, match="do not group"):
        bad_group.num_kv_heads
    with pytest.raises(grouped):
        mod.init_decode_params(bad_group)
    assert mod.DecodeConfig(n_head=4, n_kv_head=2).group_size == 2


def test_request_longer_than_max_length_is_refused_before_any_work():
    tcfg = tgen.DecodeConfig(**CFG)
    pool = tkv.KVCachePool(16, PAGE, 2, 4, 16, device="cpu")
    loop = tgen.ContinuousBatchingLoop(tgen.init_decode_params(tcfg), tcfg,
                                       pool, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_length"):
        loop.run([tgen.DecodeRequest(prompt=[1, 2], max_new_tokens=2),
                  tgen.DecodeRequest(prompt=[1] * 30, max_new_tokens=20)])
    assert pool.stats()["live_sequences"] == 0 and loop.steps == 0


def test_entry_points_without_cuda_raise(monkeypatch):
    """device=None is the card; with no card an entry point raises — it
    never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tgen.DecodeConfig(**CFG)
    with pytest.raises(tdevice.NoCudaDeviceError):
        tdevice.resolve_device()
    with pytest.raises(tdevice.NoCudaDeviceError):
        tkv.KVCachePool(4, PAGE, 2, 4, 16)
    with pytest.raises(tdevice.NoCudaDeviceError):
        tgen.TransformerDecoder(tcfg)
    pool = tkv.KVCachePool(4, PAGE, 2, 4, 16, device="cpu")
    with pytest.raises(tdevice.NoCudaDeviceError):
        tgen.ContinuousBatchingLoop(tgen.init_decode_params(tcfg), tcfg, pool)
    with pytest.raises(tdevice.NoCudaDeviceError):
        tgen.full_decode(tgen.init_decode_params(tcfg), tcfg, [1, 2], 1)


def test_loop_refuses_a_pool_on_another_device():
    tcfg = tgen.DecodeConfig(**CFG)
    pool = tkv.KVCachePool(4, PAGE, 2, 4, 16, device="cpu")
    with pytest.raises(ValueError, match="pool lives on"):
        tgen.ContinuousBatchingLoop(tgen.init_decode_params(tcfg), tcfg, pool,
                                    device="meta")


def test_importing_the_port_loads_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.serving.speculative, "
            "paddle_tpu_torch.serving.prefixcache, "
            "paddle_tpu_torch.serving.prefill_sched, "
            "paddle_tpu_torch.kernels.flash_attention, "
            "paddle_tpu_torch.kernels.paged_attention, "
            "paddle_tpu_torch.kernels.conv_epilogue, "
            "paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.models.resnet, "
            "paddle_tpu_torch.ops.metric_ops, "
            "paddle_tpu_torch.core.executor, paddle_tpu_torch.unique_name; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
