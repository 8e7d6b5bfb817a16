"""The arithmetic of the fp32 flash backward kernels, on the CPU.

``paddle_tpu_torch/kernels/csrc/flash_bwd.cu`` computes the fp32 backward
on the tensor cores with split-TF32 products: every fp32 operand x is
split as big = tf32(x) and small = tf32(x - big), tf32() rounding to
nearest with ties away from zero at 10 mantissa bits (what
``cvt.rna.tf32.f32`` does), and each product sums small·big + big·small
+ big·big, small terms first, in fp32.  The operands are Q, K, V and dO,
and P and dS, which the kernels build in registers; the five products are
S = Q K^T, dP = dO V^T, dQ = dS K, dK = dS^T Q and dV = P^T dO.

``split_model`` below is a plain model of exactly that arithmetic, written
here and nowhere else, over the split of tests/tf32_split.py.  It is held
against the port's ``flash_attention_bwd_reference`` and against the JAX
Pallas dq / dkv kernels in interpret mode (``jax.vjp`` through
``flash_attention(force="interpret")``, as tests/test_torch_kernels.py
reaches them) over head dims 64 and 128, causal and not, a klen = 0 row,
S off the 64-row tile and more keys than queries, under the fp32 gate of
``chip_smoke.py``: max abs error <= 1e-4 * max(1, max |reference|).  Only
the order of the fp32 sums moves between the model, the kernels and
either reference.

A planted fault must FAIL that gate: the same model with one TF32 product
a multiply (operands rounded once, no small terms), at the training head
shape (S 256, D 64, causal), which is why the kernels split.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")

from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402
from tf32_split import (CASES, FAULT_CASES, H, gate, inputs,  # noqa: E402
                        mm1, mm3, split, tf32)


def split_model(q, k, v, dout, lse, dvec, k_lengths, causal, scale, mm=mm3):
    """(dQ, dK, dV) of the fp32 kernels' arithmetic: q/k/v/dout [B, H, S,
    D] fp32, lse and dvec [B, H, Sq]; P = exp(scale * S - lse) on visible
    entries and exactly 0 elsewhere, dS = P * (dP - D) * scale, and every
    product through ``mm``."""
    s = mm(q, k.transpose(-1, -2))
    vis = tflash._visible(q.shape[0], s.shape[-2], s.shape[-1], causal,
                          k_lengths, q.device)
    p = torch.where(vis, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    ds = p * (mm(dout, v.transpose(-1, -2)) - dvec[..., None]) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2).contiguous(), q),
            mm(p.transpose(-1, -2).contiguous(), dout))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One case: inputs made with numpy, the port's plain forward and
    backward, and the JAX Pallas dq / dkv kernels in interpret mode."""
    B, Sq, Sk, D, causal, lens = CASES[request.param]
    q, k, v, do = inputs(sorted(CASES).index(request.param), B, Sq, Sk, D,
                         n=4)
    scale = D ** -0.5
    kl = np.asarray(lens, np.int32)
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, scale=scale, k_lengths=kl,
        force="interpret"), q, k, v)
    jax_grads = [np.asarray(g, np.float32) for g in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tkl = torch.from_numpy(kl)
    out, lse = tflash.flash_attention_fwd_reference(tq, tk, tv, causal,
                                                    scale, tkl)
    dvec = (tdo * out).sum(-1)
    plain = tflash.flash_attention_bwd_reference(tq, tk, tv, tkl, out, lse,
                                                 tdo, causal, scale)
    return dict(name=request.param, lens=lens,
                args=(tq, tk, tv, tdo, lse, dvec, tkl, causal, scale),
                plain=[g.numpy() for g in plain], jax=jax_grads)


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # a tf32 ulp on [1, 2)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2, 1.0, 0.0, -0.0, 2 ** -130],
                     dtype=torch.float32)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0, 0.0, -0.0, 2 ** -130]
    assert tf32(x).tolist() == want
    r = torch.from_numpy(np.random.RandomState(7).standard_normal(
        100000).astype(np.float32)) * 1e3
    big, small = split(r)
    for part in (big, small):  # 10 mantissa bits: the low 13 bits are 0
        assert bool(((part.view(torch.int32) & 0x1FFF) == 0).all())
    # big is the nearest tf32: off by at most half its ulp
    assert bool(((r - big).abs() <= big.abs() * 2.0 ** -11).all())
    rest = (r.double() - big.double() - small.double()).abs()
    assert bool((rest <= r.double().abs() * 2.0 ** -22).all())


def test_split_model_matches_plain_and_interpret(case):
    got = split_model(*case["args"])
    for name, g, plain, want in zip(("dq", "dk", "dv"), got, case["plain"],
                                    case["jax"]):
        assert g.dtype == torch.float32
        for ref in (plain, want):
            err, bound, ok = gate(g, ref)
            assert ok, (case["name"], name, err, bound)
    dq, dk, dv = got
    for b, n in enumerate(case["lens"]):
        if n == 0:  # a fully masked row: dQ = 0 exactly
            assert bool((dq[b] == 0).all())
        # key rows at or past klen: dK = dV = 0 exactly
        assert bool((dk[b, :, n:] == 0).all()) and bool(
            (dv[b, :, n:] == 0).all())


@pytest.mark.parametrize("case", FAULT_CASES, indirect=True)
def test_one_tf32_pass_fails_thegate(case):
    """One TF32 product a multiply, at the training head shape: each of
    dQ, dK and dV must fail the gate against both references, while the
    three-product model (above) passes it."""
    got = split_model(*case["args"], mm=mm1)
    for name, g, plain, want in zip(("dq", "dk", "dv"), got, case["plain"],
                                    case["jax"]):
        for ref in (plain, want):
            err, bound, ok = gate(g, ref)
            assert not ok, (case["name"], name, err, bound)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_products_against_float64(name):
    """Each split product against the same product in float64 over the
    case's operand shapes: within 2^-20 of the operands' scale (|a| |b|
    summed over k), where one TF32 pass is not."""
    B, Sq, Sk, D, _, _ = CASES[name]
    rng = np.random.RandomState(50 + sorted(CASES).index(name))
    a = torch.from_numpy(rng.standard_normal((B, H, Sq, D)).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal((B, H, D, Sk)).astype(
        np.float32))
    exact = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    rel3 = float(((mm3(a, b).double() - exact).abs() / scale).max())
    rel1 = float(((mm1(a, b).double() - exact).abs() / scale).max())
    assert rel3 <= 2.0 ** -20 < rel1, (rel3, rel1)
