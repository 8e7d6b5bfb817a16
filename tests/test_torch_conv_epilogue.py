"""The port's conv-epilogue kernels module (paddle_tpu_torch/kernels/
conv_epilogue.py) and the ResNet-8 conv-tier training program against the
JAX package, on the CPU.

A CUDA kernel has no interpret mode, so here ``conv_stats`` and
``bn_epilogue`` take their plain versions (the tensors lie on the CPU),
and those are held against the JAX ``conv_bn_act`` with the Pallas
kernels (rows 5-7 of the kernel table) in interpret mode.  The CUDA
kernels are held against the plain versions on the card by chip_smoke.py.

Tolerances: fp32 on both sides, different summation orders.  Kernel
outputs of O(1) agree to a few ulp: 1e-5 absolute on y, 1e-5 relative
(to the vector's largest entry) on the batch statistics; gradients within
1e-4 * max(1, max |g|).  ResNet-8 training: the loss at every step within
2e-4 relative, every param@GRAD after step 1 within 2e-3 * max(1, max
|g|), every persistable after step 3 within 2e-4.
"""

import importlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the JAX packages re-export functions named like their modules, so the
# modules are looked up by full name
jce = importlib.import_module("paddle_tpu.kernels.conv_epilogue")
jres = importlib.import_module("paddle_tpu.models.resnet")
tres = importlib.import_module("paddle_tpu_torch.models.resnet")

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.kernels import conv_epilogue as tce  # noqa: E402

# (K, stride, padding, residual, act) at x [2, 16, 16, 8] -> F = 12: the
# Pallas-viable shapes of the ResNet path — 3x3/1 pad 1 (row 5, in-kernel
# halo), 1x1/1 and 1x1/2 (row 6) — each epilogue form (row 7)
_CASES = {
    "3x3s1_res_relu": (3, 1, 1, True, "relu"),
    "3x3s1_relu": (3, 1, 1, False, "relu"),
    "1x1s1_res_relu": (1, 1, 0, True, "relu"),
    "1x1s1_none": (1, 1, 0, False, ""),
    "1x1s2_none": (1, 2, 0, False, ""),
    "1x1s2_res_relu": (1, 2, 0, True, "relu"),
}
N, H, C, FO = 2, 16, 8, 12


def _inputs(seed, K, stride, padding, residual):
    rng = np.random.default_rng(seed)
    ho = (H + 2 * padding - K) // stride + 1
    x = rng.random((N, H, H, C), dtype=np.float32)  # post-ReLU-like
    w = (rng.standard_normal((K, K, C, FO)) * (2.0 / (K * K * C)) ** 0.5
         ).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, FO).astype(np.float32)
    beta = rng.standard_normal(FO).astype(np.float32)
    z = (rng.standard_normal((N, ho, ho, FO)).astype(np.float32)
         if residual else None)
    return x, w, gamma, beta, z


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _assert_stats(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())


@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_versions_match_the_pallas_kernels(case):
    K, stride, padding, residual, act = _CASES[case]
    x, w, gamma, beta, z = _inputs(0, K, stride, padding, residual)
    assert jce.pallas_viable(N, H, H, C, FO, K, stride, padding)
    jy, jmean, jvar = jce.conv_bn_act(
        x, w, gamma, beta, z, stride=stride, padding=padding, act=act,
        interpret=True)
    # the plain versions, called by name and through the wrappers
    out, ssum, ssq = tce.conv_stats_reference(_t(x), _t(w), stride, padding)
    count = out.shape[0] * out.shape[1] * out.shape[2]
    mean = ssum / count
    var = torch.clamp(ssq / count - mean * mean, min=0.0)
    y = tce.bn_epilogue_reference(out, mean, torch.rsqrt(var + 1e-5),
                                  _t(gamma), _t(beta), _t(z), act)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    _assert_stats(mean.numpy(), jmean)
    _assert_stats(var.numpy(), jvar)
    wy, wmean, wvar = tce.conv_bn_act(_t(x), _t(w), _t(gamma), _t(beta),
                                      _t(z), stride=stride, padding=padding,
                                      act=act)
    assert torch.equal(wy, y) and torch.equal(wmean, mean)
    assert torch.equal(wvar, var)


@pytest.mark.parametrize("K,stride,padding", [(7, 2, 3), (3, 2, 1)])
def test_two_pass_reference_matches_jax_reference(K, stride, padding):
    """The shapes the Pallas envelope leaves out (the stem, the strided
    3x3): the plain two-pass composition against the JAX one."""
    x, w, gamma, beta, z = _inputs(1, K, stride, padding, True)
    want = jce.conv_bn_act_reference(x, w, gamma, beta, z, stride=stride,
                                     padding=padding)
    got = tce.conv_bn_act_reference(_t(x), _t(w), _t(gamma), _t(beta),
                                    _t(z), stride=stride, padding=padding)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    _assert_stats(got[1].numpy(), want[1])
    _assert_stats(got[2].numpy(), want[2])
    # and the one-pass wrapper agrees with it
    one = tce.conv_bn_act(_t(x), _t(w), _t(gamma), _t(beta), _t(z),
                          stride=stride, padding=padding)
    np.testing.assert_allclose(one[0].numpy(), got[0].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["3x3s1_res_relu", "1x1s1_none",
                                  "1x1s2_res_relu"])
def test_conv_bn_act_backward_matches_jax_vjp(case):
    """ConvBnAct's analytic backward against jax.vjp through
    make_conv_bn_act (Pallas forward in interpret mode, its analytic
    custom_vjp), with random cotangents on y, mean and var."""
    K, stride, padding, residual, act = _CASES[case]
    x, w, gamma, beta, z = _inputs(2, K, stride, padding, residual)
    rng = np.random.default_rng(3)
    ho = (H + 2 * padding - K) // stride + 1
    dy = rng.standard_normal((N, ho, ho, FO)).astype(np.float32)
    dmean = rng.standard_normal(FO).astype(np.float32)
    dvar = rng.standard_normal(FO).astype(np.float32)
    fn = jce.make_conv_bn_act(has_residual=residual, stride=stride,
                              padding=padding, act=act, interpret=True)
    args = (x, w, gamma, beta) + ((z,) if residual else ())
    _, vjp = jax.vjp(fn, *args)
    want = vjp((dy, dmean, dvar))
    leaves = [_t(a).requires_grad_() for a in args]
    y, mean, var = tce.conv_bn_act_trainable(
        *leaves[:4], leaves[4] if residual else None, stride=stride,
        padding=padding, act=act)
    got = torch.autograd.grad((y, mean, var), leaves,
                              (_t(dy), _t(dmean), _t(dvar)))
    for name, g, wnt in zip(("dx", "dw", "dgamma", "dbeta", "dz"), got,
                            want):
        wnt = np.asarray(wnt)
        bound = 1e-4 * max(1.0, float(np.abs(wnt).max()))
        assert float(np.abs(g.numpy() - wnt).max()) <= bound, name


def test_cpu_wrappers_count_copies_not_launches():
    x, w, gamma, beta, z = _inputs(4, 3, 1, 1, True)
    xt = _t(x).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = (tce.conv_stats.launches, tce.bn_epilogue.launches,
              tce.conv_bn_act.layout_copies,
              dict(tce.conv_stats.launches_by_shape))
    tce.conv_bn_act(_t(x), _t(w), _t(gamma), _t(beta), _t(z), padding=1)
    assert tce.conv_bn_act.layout_copies == before[2]  # NHWC: no copy
    tce.conv_bn_act(xt, _t(w), _t(gamma), _t(beta), _t(z), padding=1)
    assert tce.conv_bn_act.layout_copies == before[2] + 1  # NCHW memory
    assert (tce.conv_stats.launches, tce.bn_epilogue.launches) == before[:2]
    assert dict(tce.conv_stats.launches_by_shape) == before[3]
    with pytest.raises(ValueError):
        tce.conv_stats(_t(x).to("meta"), _t(w).to("meta"), 1, 1)
    with pytest.raises(ValueError):
        tce.bn_epilogue(_t(z), _t(beta), _t(gamma), _t(gamma), _t(beta),
                        act="sigmoid")


# -- ResNet-8 (basic blocks) through the fluid entry points -------------------

LR, MOMENTUM, BATCH, STEPS = 0.01, 0.9, 8, 3


def _build(fluid, guard, res, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = res.resnet_cifar10(depth=8, fuse_bn="conv", **kw)
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


def _steps(exe, main, loss, gnames, persist, scope, batch, steps):
    """``steps`` runs of ``main``: the losses, the step-1 gradients, the
    persistables after step 1 and at the end."""
    out = {"loss": []}
    for step in range(steps):
        fetch = [loss] + (gnames if step == 0 else [])
        vals = exe.run(main, feed=batch, fetch_list=fetch, scope=scope)
        out["loss"].append(float(np.asarray(vals[0]).reshape(-1)[0]))
        if step == 0:
            out["grads"] = [np.asarray(v) for v in vals[1:]]
            out["state1"] = {n: np.array(scope.find_var(n)) for n in persist}
    out["state"] = {n: np.array(scope.find_var(n)) for n in persist}
    return out


def run_both(jbuilt, tbuilt, batch, steps, jax_impls=("pallas",)):
    """``steps`` Momentum steps of the JAX program under each
    FLAGS_conv_epilogue of ``jax_impls`` ("pallas": the Pallas kernels in
    interpret mode; "reference": its XLA composition) and of the port's
    (CPU executor), each from the JAX startup state."""
    jmain, jstartup, jspec, jpg = jbuilt
    tmain, _, _, tpg = tbuilt
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = JScope()
    jexe.run(jstartup, scope=jscope)
    persist = sorted(n for n, v in jstartup.desc.block(0).vars.items()
                     if v.persistable)
    state = {n: np.asarray(jscope.find_var(n)) for n in persist}
    gnames = [g.name for _, g in jpg]
    assert gnames == [g.name for _, g in tpg]
    out = {"gnames": gnames, "persist": persist, "state": state}
    for impl in jax_impls:
        scope = JScope()
        for n, v in state.items():
            scope.set_var(n, v)
        jfluid.set_flags({"FLAGS_conv_epilogue": impl})
        try:
            out["jax" if impl == "pallas" else "jax_" + impl] = _steps(
                jexe, jmain, jspec.loss.name, gnames, persist, scope, batch,
                steps)
        finally:
            jfluid.set_flags({"FLAGS_conv_epilogue": "reference"})
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.load_state(state, tscope)
    before = ((tce.conv_stats.launches, tce.bn_epilogue.launches),
              tce.conv_bn_act.layout_copies)
    out["torch"] = _steps(texe, tmain, jspec.loss.name, gnames, persist,
                          tscope, batch, steps)
    out["launches"] = (before[0], (tce.conv_stats.launches,
                                   tce.bn_epilogue.launches))
    out["copies"] = tce.conv_bn_act.layout_copies - before[1]
    return out


@pytest.fixture(scope="module")
def resnet8():
    jbuilt = _build(jfluid, jguard, jres)
    tbuilt = _build(tfluid, tguard, tres)
    batch = jbuilt[2].synthetic_batch(BATCH, seed=1)
    return run_both(jbuilt, tbuilt, batch, STEPS)


def test_resnet8_losses_match_at_every_step(resnet8):
    want, got = resnet8["jax"]["loss"], resnet8["torch"]["loss"]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]


def test_resnet8_every_param_grad_matches_after_step_one(resnet8):
    assert len(resnet8["gnames"]) == 3 * 9 + 2  # 9 conv ops, the fc
    for name, g, w in zip(resnet8["gnames"], resnet8["torch"]["grads"],
                          resnet8["jax"]["grads"]):
        assert g.shape == w.shape, name
        bound = 2e-3 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= bound, name


def test_resnet8_every_persistable_matches_after_three_steps(resnet8):
    moved = 0
    for name in resnet8["persist"]:
        want = resnet8["jax"]["state"][name]
        got = resnet8["torch"]["state"][name]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        moved += ((".mean_" in name or ".var_" in name)
                  and bool(np.any(want != resnet8["state"][name])))
    assert moved == 2 * 9  # every moving mean and variance was updated


def test_resnet8_cpu_run_launches_nothing_and_copies_only_the_image(resnet8):
    before, after = resnet8["launches"]
    assert before == after
    # per step: the fed NCHW image, and the global pool's gradient (torch
    # returns it in NCHW memory) entering the last op's backward
    assert resnet8["copies"] == 2 * STEPS


def test_no_gradient_is_computed_for_the_fed_image(monkeypatch):
    """The block runner makes leaves only of inputs whose gradient a grad
    op writes: the stem's ConvBnAct backward needs no dx of the image."""
    main, startup, spec, _ = _build(tfluid, tguard, tres)
    seen = []
    backward = tce.ConvBnAct.backward

    def spy(ctx, *grads):
        seen.append(ctx.needs_input_grad[:2])
        return backward(ctx, *grads)

    monkeypatch.setattr(tce.ConvBnAct, "backward", staticmethod(spy))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=spec.synthetic_batch(2), fetch_list=[spec.loss],
            scope=scope)
    assert len(seen) == 9
    assert seen[-1] == (False, True)  # the stem, differentiated last
    assert all(s == (True, True) for s in seen[:-1])


@pytest.mark.parametrize("which", ["main", "startup"])
def test_resnet8_programs_match_op_by_op(which):
    from paddle_tpu.core.proto import ProgramDesc as JProgramDesc
    from test_torch_program import canonical

    from paddle_tpu_torch.core.proto import ProgramDesc as TProgramDesc

    idx = 0 if which == "main" else 1
    want = canonical(_build(jfluid, jguard, jres)[idx])
    got = canonical(_build(tfluid, tguard, tres)[idx])
    assert got == want
    assert (TProgramDesc.from_dict(got).fingerprint()
            == JProgramDesc.from_dict(want).fingerprint())
