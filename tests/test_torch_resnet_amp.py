"""ResNet under bf16 AMP in the port (paddle_tpu_torch) against the JAX
package, on the CPU: the bf16 plain versions of the conv-epilogue
kernels, the conv2d, batch_norm, fused_bn_add_act and conv_bn_add_act
rules, the three ``fuse_bn`` forms of ResNet built and trained.

Tolerances, and why:

- The bf16 plain versions against the Pallas kernels (rows 6-7) in
  interpret mode, on the same bf16 inputs.  Both accumulate every product
  in fp32, round the conv output to bf16 but take the statistics from the
  unrounded fp32 values, and run the epilogue in fp32 over the widened
  ``out`` and z, rounding y once.  So they differ only where fp32
  summation order moves a value across a bf16 rounding boundary: one bf16
  ulp, at most 2^-7 of the value, and rarely.  Bounds, as on the card:
  max abs error <= 2^-7 * max |JAX| and at most 1% of the elements not
  bit-equal for ``out`` and y; the batch mean and variance within 1e-4 of
  the vector's largest entry.  Statistics taken from the rounded ``out``
  (the JAX package's own reference composition), or a residual left
  unrounded, change more than 1% of y and must fail that gate.
- The analytic backward against ``jax.vjp`` of ``make_conv_bn_act(
  interpret=True)``: dx and dw come from a bf16 conv backward of dout
  rounded to bf16 on both sides, after fp32 sums in different orders, so
  each is held to 2^-6 of its norm (two bf16 ulps); dgamma and dbeta are
  fp32 sums of the same terms, within 1e-3 of their norm.
- The rules against the JAX rules: in fp32 2e-4 forward and 2e-3 for
  gradients, each relative to max(1, max |JAX|); under both AMP tiers
  every output's dtype equal to JAX's, and values within 2^-6 * max(1,
  max |JAX|) (two bf16 ulps: both sides round the same fp32 value once,
  after sums in different orders).
- Three Momentum steps of ResNet-8 under each tier, unfused, fused and
  conv forms, against the JAX executor under the same tier (its conv tier
  takes FLAGS_conv_epilogue "reference", which takes the statistics from
  the rounded conv output, so this gate also covers that rounding-point
  difference; the kernel-level cases above are the tight ones): each
  step's loss within 2^-6 relative (under keep the loss is bf16, and
  2^-6 is under three of its ulps; measured at most one), master weights
  fp32 on both sides, and
  the dtype of every var the step produces equal to JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
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
from paddle_tpu.core import amp as jamp  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.registry import OpRegistry as JOps  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core import amp as tamp  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.proto import DataType  # noqa: E402
from paddle_tpu_torch.core.registry import OpRegistry as TOps  # noqa: E402
from paddle_tpu_torch.kernels import conv_epilogue as tce  # noqa: E402

from test_torch_program import canonical  # noqa: E402

BF16_ULP = 2.0 ** -7     # kernel vs plain: max abs err <= this * max |plain|
MISMATCH_SHARE = 0.01    # at most this share of elements not bit-equal
STATS_RTOL = 1e-4        # batch mean / var, vs the vector's largest entry
BWD_CONV_RTOL = 2.0 ** -6   # dx, dw in norm
BWD_VEC_RTOL = 1e-3         # dgamma, dbeta in norm
FP32_FWD, FP32_GRAD = 2e-4, 2e-3
AMP_RULE_TOL = 2.0 ** -6    # rule values under AMP, vs max(1, max |JAX|)
LOSS_RTOL = 2.0 ** -6       # ResNet-8 steps under AMP


def _gate(got, want):
    """(max abs error over its bound, share of elements not bit-equal)."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    return err / (BF16_ULP * float(np.abs(want).max())), float(
        np.mean(got != want))


def _passes(got, want):
    ratio, share = _gate(got, want)
    return ratio <= 1.0 and share <= MISMATCH_SHARE


# -- the bf16 plain versions against Pallas interpret mode ----------------

# (K, stride, padding, residual, act) at x [2, 12, 12, 8] -> F = 16: the
# ResNet conv kinds (1x1/1, 3x3/1 pad 1, 3x3/2 pad 1, the 7x7/2 pad 3 stem),
# with and without the residual; in bf16 every one takes row 6's call
KERNEL_CASES = {
    "1x1s1_res_relu": (1, 1, 0, True, "relu"),
    "3x3s1_relu": (3, 1, 1, False, "relu"),
    "3x3s2_res_relu": (3, 2, 1, True, "relu"),
    "7x7s2_none": (7, 2, 3, False, ""),
}
N, H, C, FO = 2, 12, 8, 16


def _bf16(a):
    """(jax bf16, torch bf16) of the same values."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
    return j, t


@pytest.fixture(scope="module", params=sorted(KERNEL_CASES))
def kernel_case(request):
    """JAX ``conv_bn_act(interpret=True, return_conv=True)`` on bf16
    inputs, beside the same inputs as torch tensors."""
    K, stride, padding, residual, act = KERNEL_CASES[request.param]
    rng = np.random.default_rng(sorted(KERNEL_CASES).index(request.param))
    ho = (H + 2 * padding - K) // stride + 1
    jx, x = _bf16(rng.random((N, H, H, C), dtype=np.float32))
    jw, w = _bf16(rng.standard_normal((K, K, C, FO)).astype(np.float32)
                  * (2.0 / (K * K * C)) ** 0.5)
    gamma = rng.uniform(0.5, 1.5, FO).astype(np.float32)
    beta = rng.standard_normal(FO).astype(np.float32)
    zf = (rng.standard_normal((N, ho, ho, FO)).astype(np.float32)
          if residual else None)
    jz, z = _bf16(zf) if residual else (None, None)
    y, mean, var, out = jce.conv_bn_act(
        jx, jw, gamma, beta, jz, stride=stride, padding=padding, act=act,
        interpret=True, return_conv=True)
    assert y.dtype == out.dtype == jnp.bfloat16
    assert mean.dtype == var.dtype == jnp.float32
    return dict(x=x, w=w, gamma=torch.from_numpy(gamma),
                beta=torch.from_numpy(beta), z=z, zf=zf, jargs=(
                    jx, jw, gamma, beta, jz), stride=stride,
                padding=padding, act=act, residual=residual,
                y=np.asarray(y, np.float32), out=np.asarray(out, np.float32),
                mean=np.asarray(mean), var=np.asarray(var))


def _plain(c):
    """The bf16 plain versions in the kernels' order: (out, mean, var,
    inv, y)."""
    out, ssum, ssq = tce.conv_stats_reference(c["x"], c["w"], c["stride"],
                                              c["padding"])
    mean, var = tce._batch_stats(out, ssum, ssq)
    inv = torch.rsqrt(var + 1e-5)
    y = tce.bn_epilogue_reference(out, mean, inv, c["gamma"], c["beta"],
                                  c["z"], c["act"])
    return out, mean, var, inv, y


def _assert_stats(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert float(np.abs(got - want).max()) <= STATS_RTOL * float(
        np.abs(want).max())


def test_bf16_plain_versions_match_pallas_interpret(kernel_case):
    c = kernel_case
    out, mean, var, _, y = _plain(c)
    assert out.dtype == y.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    assert _passes(out, c["out"]), _gate(out, c["out"])
    assert _passes(y, c["y"]), _gate(y, c["y"])
    _assert_stats(mean, c["mean"])
    _assert_stats(var, c["var"])
    # the wrappers on CPU tensors are the plain versions
    wy, wmean, wvar = tce.conv_bn_act(
        c["x"], c["w"], c["gamma"], c["beta"], c["z"], stride=c["stride"],
        padding=c["padding"], act=c["act"])
    assert torch.equal(wy, y) and torch.equal(wmean, mean)
    assert torch.equal(wvar, var)


def test_moved_rounding_points_fail_the_gate(kernel_case):
    """Statistics from the rounded ``out`` (JAX's reference composition,
    two-pass variance), or the residual left unrounded in fp32: each
    changes more than MISMATCH_SHARE of y."""
    c = kernel_case
    y_rounded_stats = tce.conv_bn_act_reference(
        c["x"], c["w"], c["gamma"], c["beta"], c["z"], stride=c["stride"],
        padding=c["padding"], act=c["act"])[0]
    assert y_rounded_stats.dtype == torch.bfloat16
    assert not _passes(y_rounded_stats, c["y"])
    if c["residual"]:
        out, mean, _, inv, _ = _plain(c)
        zf = torch.from_numpy(c["zf"])
        y_unrounded_z = ((out.float() - mean) * inv * c["gamma"] + c["beta"]
                         + zf).relu().to(torch.bfloat16)
        assert not _passes(y_unrounded_z, c["y"])


@pytest.mark.parametrize("case", ["3x3s2_res_relu", "1x1s1_res_relu"])
def test_bf16_analytic_backward_matches_jax_vjp(case):
    """ConvBnAct's backward on bf16 x, w, z and fp32 gamma, beta against
    jax.vjp through make_conv_bn_act(interpret=True), with random
    cotangents on y (bf16), mean and var (fp32): dx, dw, dz bf16, dgamma
    and dbeta fp32."""
    K, stride, padding, residual, act = KERNEL_CASES[case]
    rng = np.random.default_rng(11)
    ho = (H + 2 * padding - K) // stride + 1
    pairs = [_bf16(rng.random((N, H, H, C), dtype=np.float32)),
             _bf16(rng.standard_normal((K, K, C, FO)).astype(np.float32)
                   * (2.0 / (K * K * C)) ** 0.5)]
    gamma = rng.uniform(0.5, 1.5, FO).astype(np.float32)
    beta = rng.standard_normal(FO).astype(np.float32)
    z = _bf16(rng.standard_normal((N, ho, ho, FO)).astype(np.float32))
    jdy, dy = _bf16(rng.standard_normal((N, ho, ho, FO)).astype(np.float32))
    dmean = rng.standard_normal(FO).astype(np.float32)
    dvar = rng.standard_normal(FO).astype(np.float32)
    fn = jce.make_conv_bn_act(has_residual=True, stride=stride,
                              padding=padding, act=act, interpret=True)
    _, vjp = jax.vjp(fn, pairs[0][0], pairs[1][0], gamma, beta, z[0])
    want = vjp((jdy, dmean, dvar))
    leaves = [pairs[0][1], pairs[1][1], torch.from_numpy(gamma),
              torch.from_numpy(beta), z[1]]
    leaves = [t.clone().requires_grad_() for t in leaves]
    y, mean, var = tce.conv_bn_act_trainable(*leaves, stride=stride,
                                             padding=padding, act=act)
    got = torch.autograd.grad((y, mean, var), leaves,
                              (dy, torch.from_numpy(dmean),
                               torch.from_numpy(dvar)))
    for name, g, w, leaf in zip(("dx", "dw", "dgamma", "dbeta", "dz"), got,
                                want, leaves):
        assert g.dtype == leaf.dtype, name
        assert str(np.asarray(w).dtype) == str(leaf.dtype).removeprefix(
            "torch."), name
        w = np.asarray(w, np.float64)
        rel = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
        bound = BWD_VEC_RTOL if name in ("dgamma", "dbeta") else BWD_CONV_RTOL
        assert rel <= bound, (name, rel)


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_conv_epilogue_refuses_other_and_mixed_dtypes(dtypes):
    x = torch.zeros(1, 4, 4, 8, dtype=dtypes[0])
    w = torch.zeros(1, 1, 8, 8, dtype=dtypes[1])
    with pytest.raises(TypeError):
        tce.conv_stats(x, w)
    vec = torch.zeros(8)
    with pytest.raises(TypeError):
        tce.bn_epilogue(x, vec, vec, vec, vec, x.to(dtypes[1])
                        if dtypes[0] != dtypes[1] else None)


# -- the rules against the JAX rules --------------------------------------

class _JCtx:
    """What the JAX rules read of their lowering context."""

    is_test = False


def _bn_ins(rng, c):
    return {"Scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "Bias": rng.standard_normal(c).astype(np.float32),
            "Mean": rng.standard_normal(c).astype(np.float32) * 0.1,
            "Variance": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _conv_case(attrs, groups=1):
    def make(rng):
        return {"Input": rng.random((2, 4, 9, 9), dtype=np.float32),
                "Filter": rng.standard_normal((6, 4 // groups, 3, 3)).astype(
                    np.float32) * 0.3}, dict(attrs, groups=groups)
    return "conv2d", make, "Output", ["Input", "Filter"]


def _bn_case(op, attrs, layout="NCHW", residual=False):
    def make(rng):
        shape = (4, 6, 5, 5) if layout == "NCHW" else (4, 5, 5, 6)
        ins = {"X": rng.standard_normal(shape).astype(np.float32) * 2 + 0.5,
               **_bn_ins(rng, 6)}
        if residual:
            ins["Z"] = rng.standard_normal(shape).astype(np.float32)
        return ins, dict({"momentum": 0.9, "epsilon": 1e-5,
                          "data_layout": layout}, **attrs)
    diff = ["X", "Scale", "Bias"] + (["Z"] if residual else [])
    return op, make, "Y", diff


def _cbaa_case(attrs, residual=True):
    def make(rng):
        ins = {"X": rng.random((2, 4, 8, 8), dtype=np.float32),
               "Filter": rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
               * 0.3, **_bn_ins(rng, 6)}
        if residual:
            ins["Z"] = rng.standard_normal((2, 6, 4, 4)).astype(np.float32)
        return ins, dict({"strides": [2, 2], "paddings": [1, 1],
                          "momentum": 0.9, "epsilon": 1e-5}, **attrs)
    diff = ["X", "Filter", "Scale", "Bias"] + (["Z"] if residual else [])
    return "conv_bn_add_act", make, "Y", diff


RULE_CASES = {
    "conv2d_s2p1": _conv_case({"strides": [2, 2], "paddings": [1, 1],
                               "dilations": [1, 1]}),
    "conv2d_dilated": _conv_case({"strides": [1, 1], "paddings": [2, 2],
                                  "dilations": [2, 2]}),
    "conv2d_groups2": _conv_case({"strides": [1, 2], "paddings": [1, 0],
                                  "dilations": [1, 1]}, groups=2),
    "batch_norm_train": _bn_case("batch_norm", {"is_test": False}),
    "batch_norm_train_nhwc": _bn_case("batch_norm", {"is_test": False},
                                      layout="NHWC"),
    "batch_norm_is_test": _bn_case("batch_norm", {"is_test": True}),
    "batch_norm_global_stats": _bn_case("batch_norm",
                                        {"use_global_stats": True}),
    "fused_z_relu": _bn_case("fused_bn_add_act", {"act": "relu"},
                             residual=True),
    "fused_z_none": _bn_case("fused_bn_add_act", {"act": None},
                             residual=True),
    "fused_relu": _bn_case("fused_bn_add_act", {"act": "relu"}),
    "fused_none": _bn_case("fused_bn_add_act", {"act": None}),
    "fused_is_test_z_relu": _bn_case("fused_bn_add_act",
                                     {"act": "relu", "is_test": True},
                                     residual=True),
    "conv_bn_add_act_z_relu": _cbaa_case({"act": "relu"}),
    "conv_bn_add_act_none": _cbaa_case({"act": None}, residual=False),
}


def _run_rules(case, cast=None, seed=0):
    """Both rules on the same inputs (``cast`` names the dtype of X /
    Input and Z): {slot: (torch, jax)} of every output, plus the inputs."""
    op, make, _, _ = RULE_CASES[case]
    ins, attrs = make(np.random.default_rng(seed))
    jins, tins = {}, {}
    for slot, a in ins.items():
        dtype = cast if cast and slot in ("X", "Input", "Z") else "float32"
        jins[slot] = [jnp.asarray(a).astype(dtype)]
        tins[slot] = [torch.from_numpy(a).to(getattr(torch, dtype))]
    want = JOps.get(op).lower(_JCtx(), jins, dict(attrs))
    got = TOps.get(op).lower(None, tins, dict(attrs))
    assert sorted(got) == sorted(want)
    return {slot: (got[slot][0], want[slot][0]) for slot in want}, ins, attrs


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_matches_jax_in_fp32(case):
    """Every output within 2e-4 * max(1, max |JAX|); the gradients of the
    main output with respect to every differentiable input within 2e-3 *
    max(1, max |JAX|), for a random cotangent."""
    outs, ins, attrs = _run_rules(case)
    for slot, (got, want) in outs.items():
        want = np.asarray(want)
        assert got.dtype == torch.float32, slot
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=FP32_FWD * max(1.0, float(
                                       np.abs(want).max())), err_msg=slot)
    op, _, out_slot, diff = RULE_CASES[case]
    cot = np.random.default_rng(7).standard_normal(
        np.asarray(outs[out_slot][1]).shape).astype(np.float32)

    def jfn(*xs):
        jins = {k: [jnp.asarray(v)] for k, v in ins.items()}
        jins.update({k: [x] for k, x in zip(diff, xs)})
        return JOps.get(op).lower(_JCtx(), jins, dict(attrs))[out_slot][0]

    _, vjp = jax.vjp(jfn, *[jnp.asarray(ins[k]) for k in diff])
    want = vjp(jnp.asarray(cot))
    leaves = {k: torch.from_numpy(ins[k]).requires_grad_() for k in diff}
    tins = {k: [leaves.get(k, torch.from_numpy(v))] for k, v in ins.items()}
    y = TOps.get(op).lower(None, tins, dict(attrs))[out_slot][0]
    got = torch.autograd.grad(y, [leaves[k] for k in diff],
                              torch.from_numpy(cot))
    for name, g, w in zip(diff, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=FP32_GRAD * max(
            1.0, float(np.abs(w).max())), err_msg=name)


TIERS = {"amp1": False, "keep": True}


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_outputs_have_jax_dtypes_under_amp(case, tier, x_dtype):
    """Under each tier, with an fp32 activation (the fed image, amp1's
    activations) and a bf16 one (keep's), every output of the rule has the
    JAX rule's dtype, and its values lie within AMP_RULE_TOL * max(1, max
    |JAX|).  For conv_bn_add_act this is the AMP fault the port's rule had
    (Y fp32 under keep, the conv in fp32 under amp1)."""
    for amp in (jamp, tamp):
        amp.enable_amp("bfloat16", keep_output=TIERS[tier])
    try:
        outs, _, _ = _run_rules(case, cast=x_dtype)
    finally:
        jamp.reset_amp()
        tamp.reset_amp()
    for slot, (got, want) in outs.items():
        want = np.asarray(want, np.float32) if want.dtype == jnp.bfloat16 \
            else np.asarray(want)
        assert str(got.dtype).removeprefix("torch.") == str(
            outs[slot][1].dtype), slot
        err = float(np.abs(got.detach().float().numpy() - want).max())
        assert err <= AMP_RULE_TOL * max(1.0, float(np.abs(want).max())), (
            slot, err)


# -- the three forms of ResNet --------------------------------------------

SMALL = dict(depth=50, class_num=10, img_shape=(3, 64, 64))
FORMS = {"unfused": False, "fused": True, "conv": "conv"}


def _build(pkg, builder, fuse_bn, lr=0.01, **kw):
    fluid, guard, res = ((jfluid, jguard, jres) if pkg == "jax"
                         else (tfluid, tguard, tres))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = getattr(res, builder)(fuse_bn=fuse_bn, **kw)
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9).minimize(spec.loss)
    return main, startup, spec, params_grads


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("model", ["resnet8_cifar10", "resnet50_imagenet_64"])
def test_resnet_forms_build_jax_descs(model, form):
    """Main and startup descs equal to JAX's, op by op and var by var,
    after uid canonicalisation."""
    builder, kw = (("resnet_cifar10", dict(depth=8)) if model.startswith(
        "resnet8") else ("resnet_imagenet", SMALL))
    j = _build("jax", builder, FORMS[form], **kw)
    t = _build("torch", builder, FORMS[form], **kw)
    for idx in (0, 1):
        want = canonical(j[idx])["blocks"]
        got = canonical(t[idx])["blocks"]
        assert len(got[0]["ops"]) == len(want[0]["ops"])
        for i, (g, w) in enumerate(zip(got[0]["ops"], want[0]["ops"])):
            assert g == w, f"op {i} ({w['type']})"
        assert got[0]["vars"] == want[0]["vars"]
    ops = [op.type for op in t[0].desc.block(0).ops]
    n_conv = 9 if builder == "resnet_cifar10" else 53
    if form == "conv":
        assert ops.count("conv_bn_add_act") == n_conv
    else:
        bn = "fused_bn_add_act" if form == "fused" else "batch_norm"
        assert ops.count("conv2d") == ops.count(bn) == n_conv
        assert ops.count("conv2d_grad") == ops.count(bn + "_grad") == n_conv


# -- three Momentum steps of ResNet-8 under each tier ---------------------

STEP_RUNS = {"unfused_amp1": (False, False), "unfused_keep": (False, True),
             "fused_amp1": (True, False), "conv_amp1": ("conv", False),
             "conv_keep": ("conv", True)}
STEPS, BATCH = 3, 4


def _produced(program):
    names = []
    for op in program.desc.block(0).ops:
        for ns in op.outputs.values():
            names += [n for n in ns if n and n not in names]
    return names


@pytest.fixture(scope="module", params=sorted(STEP_RUNS))
def step_run(request):
    """Three steps of ResNet-8 (batch 4) in each package from the JAX
    startup state under one form and tier; step 1 fetches every var the
    step produces, unconverted."""
    fuse_bn, keep = STEP_RUNS[request.param]
    for amp in (jamp, tamp):
        amp.enable_amp("bfloat16", keep_output=keep)
    try:
        jmain, jstartup, jspec, jpg = _build("jax", "resnet_cifar10",
                                             fuse_bn, depth=8)
        tmain, _, _, tpg = _build("torch", "resnet_cifar10", fuse_bn,
                                  depth=8)
        jscope, jexe = JScope(), jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup, scope=jscope)
        persist = sorted(n for n, v in jstartup.desc.block(0).vars.items()
                         if v.persistable)
        tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        texe.load_state({n: np.asarray(jscope.find_var(n)) for n in persist},
                        tscope)
        batch = jspec.synthetic_batch(BATCH, seed=1)
        produced = _produced(jmain)
        before = (tce.conv_stats.launches, tce.bn_epilogue.launches)
        out = {"loss": {"jax": [], "torch": []}, "produced": produced,
               "block": tmain.desc.block(0), "keep": keep,
               "fuse_bn": fuse_bn}
        for step in range(STEPS):
            fetch = [jspec.loss.name] + (produced if step == 0 else [])
            for pkg, exe, main, scope in (("jax", jexe, jmain, jscope),
                                          ("torch", texe, tmain, tscope)):
                vals = exe.run(main, feed=batch, fetch_list=fetch,
                               scope=scope, return_numpy=False)
                loss = (vals[0].float().numpy() if pkg == "torch"
                        else np.asarray(vals[0], np.float32))
                out["loss"][pkg].append(float(loss.reshape(-1)[0]))
                if step == 0:
                    out[pkg] = dict(zip(produced, vals[1:]))
        out["launched"] = (tce.conv_stats.launches - before[0],
                           tce.bn_epilogue.launches - before[1])
        out["state_dtypes"] = {
            pkg: {str(scope.find_var(n).dtype) for n in persist}
            for pkg, scope in (("jax", jscope), ("torch", tscope))}
        return out
    finally:
        jamp.reset_amp()
        tamp.reset_amp()


def test_amp_steps_losses_match_jax(step_run):
    want, got = step_run["loss"]["jax"], step_run["loss"]["torch"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_amp_steps_every_var_has_jax_dtype(step_run):
    """The runtime dtype of each var step 1 produces equals the JAX one's,
    floating dtypes exactly; an int64 desc JAX holds as int32 (x64 off),
    the port as declared.  Under keep the conv outputs, batch-norm outputs
    and residual sums are bf16, and the moving statistics fp32."""
    block = step_run["block"]
    for name in step_run["produced"]:
        want = str(np.asarray(step_run["jax"][name]).dtype)
        got = str(step_run["torch"][name].dtype).removeprefix("torch.")
        if want == "int32" and block.vars[name].dtype == DataType.INT64:
            want = "int64"
        assert got == want, name
    conv_like = ("conv_bn_add_act", "conv2d", "batch_norm",
                 "fused_bn_add_act")
    ys = [n for op in block.ops if op.type in conv_like
          for slot in ("Y", "Output") for n in op.outputs.get(slot, [])]
    stats = [n for op in block.ops if op.type in conv_like
             for slot in ("MeanOut", "VarianceOut")
             for n in op.outputs.get(slot, [])]
    want = torch.bfloat16 if step_run["keep"] else torch.float32
    assert len(ys) == 9 * (1 if step_run["fuse_bn"] == "conv" else 2)
    assert {step_run["torch"][n].dtype for n in ys} == {want}
    assert {step_run["torch"][n].dtype for n in stats} == {torch.float32}


def test_amp_steps_keep_fp32_master_weights_and_launch_nothing(step_run):
    assert step_run["state_dtypes"]["torch"] == {"torch.float32"}
    assert step_run["state_dtypes"]["jax"] == {"float32"}
    assert step_run["launched"] == (0, 0)
