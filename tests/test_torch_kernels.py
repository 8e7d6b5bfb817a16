"""The port's kernel modules (paddle_tpu_torch/kernels) against the JAX
package's, on the CPU.

A CUDA kernel has no interpret mode, so here each wrapper takes its plain
PyTorch version (the tensors lie on the CPU) and the plain version is held
against the JAX function on the same numpy inputs — through the Pallas
kernel in interpret mode and through the JAX reference path.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.

Tolerances: both sides compute in float32 with different summation
orders (XLA's CPU dot and the Pallas interpreter's block-wise online
softmax against torch's CPU matmul and one-shot softmax), so outputs of
O(1) agree to a few ulp; rtol/atol 2e-5 leaves an order of magnitude of
room and still catches any masking or layout fault, which moves outputs
by O(0.1).
"""

import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the JAX kernels package re-exports a function named like its module,
# so the modules are looked up by full name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")
jpaged = importlib.import_module("paddle_tpu.kernels.paged_attention")
jkv = importlib.import_module("paddle_tpu.serving.kvcache")

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402
from paddle_tpu_torch.kernels import paged_attention as tpaged  # noqa: E402
from paddle_tpu_torch.serving import kvcache as tkv  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, B, H, Sq, Sk, D):
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, H, Sk, D)).astype(np.float32)
    return q, k, v


# (causal, Sq, Sk, k_lengths): ragged lengths with a 0-length row, S not a
# multiple of the TPU kernel's 128 block, and cached keys (Sk > Sq, where
# causal alignment is bottom-right)
_FLASH_CASES = {
    "causal_ragged_zero_len": (True, 37, 37, [37, 20, 0]),
    "noncausal_ragged": (False, 37, 37, [5, 37, 1]),
    "causal_cached_keys": (True, 9, 41, [41, 30, 12]),
    "causal_full_len": (True, 16, 16, None),
}


@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_reference_attention_matches_jax_flash(case):
    causal, Sq, Sk, klen = _FLASH_CASES[case]
    rng = np.random.RandomState(sorted(_FLASH_CASES).index(case))
    q, k, v = _qkv(rng, 3, 2, Sq, Sk, 16)
    scale = 16 ** -0.5
    kl = None if klen is None else np.asarray(klen, np.int32)
    got = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale,
        k_lengths=None if kl is None else torch.from_numpy(kl)).numpy()
    for force in ("interpret", "jax"):
        want = np.asarray(jflash.flash_attention(
            q, k, v, causal=causal, scale=scale, k_lengths=kl, force=force))
        np.testing.assert_allclose(got, want, err_msg=force, **TOL)
    if kl is not None and (kl == 0).any():
        # the fully masked row returns zeros, not the mean of V
        assert np.all(got[kl == 0] == 0.0)


def test_reference_attention_causal_is_bottom_right():
    """Sk > Sq: query i sees keys j <= i + Sk - Sq (tril(k=Sk-Sq)), not
    torch.tril's default top-left diagonal."""
    rng = np.random.RandomState(7)
    q, k, v = _qkv(rng, 1, 1, 3, 8, 4)
    got = tflash.reference_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, scale=0.5).numpy()
    for i in range(3):
        s = q[0, 0, i] @ k[0, 0, :i + 6].T * 0.5
        w = np.exp(s - s.max())
        want = (w / w.sum()) @ v[0, 0, :i + 6]
        np.testing.assert_allclose(got[0, 0, i], want, **TOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 2, 5, 5, 8))
    before = tflash.flash_attention.launches
    got = tflash.flash_attention(q, k, v, causal=True, scale=0.3,
                                 k_lengths=[5, 3])
    want = tflash.reference_attention(q, k, v, True, 0.3, k_lengths=[5, 3])
    assert torch.equal(got, want)
    assert tflash.flash_attention.launches == before
    pbefore = tpaged.paged_decode_attention.launches
    pages = torch.from_numpy(
        rng.standard_normal((2, 4, 2, 8)).astype(np.float32))
    tables = np.asarray([[1, 2], [3, 0]], np.int32)
    out = tpaged.paged_decode_attention(q[:, :, :1], pages, pages, tables,
                                        np.asarray([4, 1], np.int32))
    assert out.shape == (2, 2, 1, 8)
    assert tpaged.paged_decode_attention.launches == pbefore


def test_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(q, q, q, causal=True)
    pages = torch.zeros(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tpaged.paged_decode_attention(q[:, :, :1], pages, pages,
                                      np.zeros((1, 1), np.int32),
                                      np.ones(1, np.int32))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit, no kernel: the build raises instead of letting a caller
    drift onto the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc()


def test_library_hash_covers_included_headers(monkeypatch, tmp_path):
    """A library's name hashes its source and the csrc/ headers it
    includes, transitively: editing a header rebuilds every source that
    includes it and no other, so no stale library is loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <cstdint>\nint b;\n")
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    before = {n: _build._target(n) for n in ("a", "b")}
    (tmp_path / "g.cuh").write_text("int g2;\n")
    after = {n: _build._target(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]
    assert before["a"].name.startswith("liba-")
    # the actual sources: both flash sources include the split helpers
    monkeypatch.undo()
    for name in ("flash_fwd", "flash_bwd"):
        data = _build._source_bytes(_build.CSRC / f"{name}.cu")
        assert (_build.CSRC / "tf32_split.cuh").read_bytes() in data


def test_launch_error_codes_raise():
    _build.check(0, "flash_fwd")
    with pytest.raises(_build.KernelLaunchError, match="cudaError_t 9"):
        _build.check(9, "flash_fwd")


# -- flash backward ------------------------------------------------------

# (causal, Sq, Sk, k_lengths): as _FLASH_CASES, plus Sq > Sk, where the
# bottom-right causal frontier masks whole query rows
_BWD_CASES = {
    **_FLASH_CASES,
    "causal_more_queries_than_keys": (True, 41, 9, [9, 3, 0]),
}


def _jax_lse(q, k, v, kl, causal, scale):
    """The JAX forward's lse, unpacked from its [B*H, nqb, bq] residual
    layout (flash_attention.py:76-95) to [B, H, Sq]."""
    B, H, Sq, _ = q.shape
    klf = np.full(B, k.shape[2], np.float32) if kl is None else kl.astype(
        np.float32)
    _, lse = jflash._pallas_flash(q, k, v, klf, causal, scale,
                                  interpret=True, need_lse=True)
    return np.asarray(lse).reshape(B * H, -1)[:, :Sq].reshape(B, H, Sq)


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_fwd_reference_out_and_lse_match_jax_interpret(case):
    causal, Sq, Sk, klen = _BWD_CASES[case]
    rng = np.random.RandomState(20 + sorted(_BWD_CASES).index(case))
    q, k, v = _qkv(rng, 3, 2, Sq, Sk, 16)
    scale = 16 ** -0.5
    kl = None if klen is None else np.asarray(klen, np.int32)
    out, lse = tflash.flash_attention_fwd_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, None if kl is None else torch.from_numpy(kl))
    want_out = np.asarray(jflash.flash_attention(
        q, k, v, causal=causal, scale=scale, k_lengths=kl,
        force="interpret"))
    want_lse = _jax_lse(q, k, v, kl, causal, scale)
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    # a fully masked row: lse = +1e30, so exp(S - lse) is 0 in backward
    assert (lse.numpy()[want_lse > 1e29] == 1e30).all()


@pytest.mark.parametrize("case", sorted(_BWD_CASES))
def test_bwd_reference_matches_jax_pallas_kernels_in_interpret(case):
    """jax.grad through flash_attention(force='interpret') runs the
    Pallas dq and dkv kernels (the interpret-mode backward); the port's
    plain backward formula must give the same dQ, dK, dV."""
    causal, Sq, Sk, klen = _BWD_CASES[case]
    rng = np.random.RandomState(40 + sorted(_BWD_CASES).index(case))
    q, k, v = _qkv(rng, 3, 2, Sq, Sk, 16)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    scale = 16 ** -0.5
    kl = None if klen is None else np.asarray(klen, np.int32)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, scale=scale, k_lengths=kl,
        force="interpret"), q, k, v)
    want = [np.asarray(g) for g in vjp(dout)]
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkl = None if kl is None else torch.from_numpy(kl)
    out, lse = tflash.flash_attention_fwd_reference(tq, tk, tv, causal,
                                                    scale, tkl)
    got = tflash.flash_attention_bwd_reference(
        tq, tk, tv, tkl, out, lse, torch.from_numpy(dout), causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    if kl is not None and (kl == 0).any():
        assert np.all(got[0].numpy()[kl == 0] == 0.0)  # dQ of a 0 row


def test_autograd_through_flash_attention_takes_the_plain_backward():
    """With inputs that require a gradient, flash_attention is the
    autograd Function: on CPU tensors its backward is
    flash_attention_bwd_reference exactly, and no kernel is counted."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(rng, 2, 2, 19, 19, 8))
    dout = torch.from_numpy(rng.standard_normal((2, 2, 19, 8)).astype(
        np.float32))
    kl = torch.tensor([19, 6], dtype=torch.int32)
    before = (tflash.flash_attention.launches, tflash.flash_bwd_dq.launches,
              tflash.flash_bwd_dkv.launches)
    out = tflash.flash_attention(q, k, v, causal=True, scale=0.4,
                                 k_lengths=kl)
    out.backward(dout)
    ref_out, lse = tflash.flash_attention_fwd_reference(
        q.detach(), k.detach(), v.detach(), True, 0.4, kl)
    want = tflash.flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), kl, ref_out, lse, dout, True,
        0.4)
    assert torch.equal(out.detach(), ref_out)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)
    assert (tflash.flash_attention.launches, tflash.flash_bwd_dq.launches,
            tflash.flash_bwd_dkv.launches) == before


def test_backward_wrappers_refuse_devices_other_than_cuda_and_cpu():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    lse = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention_bwd(q, q, q, None, q, lse, q, True, 0.125)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention_fwd(q, q, q, True, 0.125)


# -- paged decode --------------------------------------------------------

def _paged_inputs(rng, B, Hq, Hkv, D, page_size, lengths, num_pages):
    """A pool layer plus zero-padded page tables of distinct pages."""
    k_pages = rng.standard_normal((Hkv, num_pages, page_size, D)).astype(
        np.float32)
    v_pages = rng.standard_normal((Hkv, num_pages, page_size, D)).astype(
        np.float32)
    n_pages = [-(-n // page_size) for n in lengths]
    tables = np.zeros((B, max(max(n_pages), 1)), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    at = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = perm[at:at + n]
        at += n
    q = rng.standard_normal((B, Hq, 1, D)).astype(np.float32)
    return q, k_pages, v_pages, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("group", [1, 2])
def test_paged_reference_matches_jax_paged_decode(group):
    rng = np.random.RandomState(10 + group)
    Hkv, D, page_size = 2, 16, 4
    q, kp, vp, tables, lengths = _paged_inputs(
        rng, 4, Hkv * group, Hkv, D, page_size, [9, 1, 16, 0], 24)
    got = tpaged.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        tables, lengths).numpy()
    for impl in ("interpret", "reference"):
        want = np.asarray(jpaged.paged_decode_attention(
            q, kp, vp, tables, lengths, impl=impl))
        np.testing.assert_allclose(got, want, err_msg=impl, **TOL)
    assert np.all(got[3] == 0.0)  # length 0: zeros


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_ungroupable_heads_raise_grouped_heads_error(pkg):
    """H_q % H_kv != 0 is the same typed config error in both packages."""
    q = np.zeros((1, 3, 1, 8), np.float32)
    pages = np.zeros((2, 2, 4, 8), np.float32)
    tables, lengths = np.zeros((1, 1), np.int32), np.ones(1, np.int32)
    if pkg == "jax":
        err, call = jpaged.GroupedHeadsError, jpaged.paged_decode_attention
        args = (q, pages, pages)
    else:
        err, call = tpaged.GroupedHeadsError, tpaged.paged_decode_attention
        args = (torch.from_numpy(q), torch.from_numpy(pages),
                torch.from_numpy(pages))
    assert issubclass(err, ValueError)
    with pytest.raises(err, match="do not group"):
        call(*args, tables, lengths)


def test_paged_decode_multistep_over_matching_pools():
    """The mirror of the JAX multi-step parity test: both packages' pools
    take the same appends and K/V writes (ragged prefixes, an odd page
    size, mixed page counts, GQA G=2); after every step the pool contents
    are identical — the in-place write lands where the functional one
    did — and the port's paged decode matches the JAX kernel in
    interpret mode and the JAX reference gather."""
    Hq, Hkv, Dh, page_size = 4, 2, 8, 3
    kw = dict(num_pages=32, page_size=page_size, num_layers=1,
              num_heads=Hq, head_dim=Dh, num_kv_heads=Hkv)
    jpool = jkv.KVCachePool(**kw)
    tpool = tkv.KVCachePool(**kw, device="cpu")
    rng = np.random.RandomState(23)
    seq_ids = [0, 1, 2, 3]
    for s in seq_ids:
        jpool.allocate(s)
        tpool.allocate(s)

    def write(ids):
        jp, js = jpool.append_token(ids)
        tp, ts = tpool.append_token(ids)
        np.testing.assert_array_equal(jp, tp)
        np.testing.assert_array_equal(js, ts)
        k = rng.standard_normal((len(ids), Hkv, Dh)).astype(np.float32)
        v = rng.standard_normal((len(ids), Hkv, Dh)).astype(np.float32)
        jpool.write_kv(0, jp, js, k, v)
        tpool.write_kv(0, tp, ts, torch.from_numpy(k), torch.from_numpy(v))

    for s, prefix in zip(seq_ids, (5, 1, 9, 3)):
        for _ in range(prefix):
            write([s])
    for step in range(8):
        write(seq_ids)
        np.testing.assert_array_equal(np.asarray(jpool.k_pages),
                                      tpool.k_pages.numpy())
        np.testing.assert_array_equal(np.asarray(jpool.v_pages),
                                      tpool.v_pages.numpy())
        tables, lengths = tpool.page_table_batch(seq_ids)
        jt, jl = jpool.page_table_batch(seq_ids)
        np.testing.assert_array_equal(tables, jt)
        np.testing.assert_array_equal(lengths, jl)
        assert len(set(tables.shape[1] - (lengths - 1) // page_size)) > 1
        q = rng.standard_normal((4, Hq, 1, Dh)).astype(np.float32)
        got = tpaged.paged_decode_attention(
            torch.from_numpy(q), tpool.k_pages[0], tpool.v_pages[0],
            tables, lengths).numpy()
        for impl in ("interpret", "reference"):
            want = np.asarray(jpaged.paged_decode_attention(
                q, jpool.k_pages[0], jpool.v_pages[0], jt, jl, impl=impl))
            np.testing.assert_allclose(got, want,
                                       err_msg=f"step {step} {impl}", **TOL)


def test_gather_and_repeat_kv_match_jax():
    rng = np.random.RandomState(5)
    pages = rng.standard_normal((2, 6, 3, 4)).astype(np.float32)
    tables = np.asarray([[4, 1, 0], [2, 5, 3]], np.int32)
    got = tpaged.gather_kv_pages(torch.from_numpy(pages), tables)
    want = np.asarray(jpaged.gather_kv_pages(pages, tables))
    np.testing.assert_array_equal(got.numpy(), want)
    gk, gv = tpaged.repeat_kv(got, got, 3)
    wk, _ = jpaged.repeat_kv(want, want, 3)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    assert gv.shape == (2, 6, 9, 4)
