"""ResNet-50 on the conv-epilogue tier through the port's fluid entry
points against the JAX package, on the CPU.

Both packages build ``resnet_imagenet(depth=50, fuse_bn="conv")`` and
MomentumOptimizer.minimize; the descs must be equal after uid
canonicalisation.  Then both train from the JAX startup state: the JAX
executor with FLAGS_conv_epilogue=pallas (Pallas rows 5-7 in interpret
mode where ``pallas_viable`` allows, its reference composition elsewhere),
the port's CPU executor through the plain versions of its kernels.

Tolerances.  The forward is well conditioned: the step-1 loss and the
moving means and variances after step 1 (batch statistics only) agree
within 2e-4.  The gradients are not, in fp32, at ResNet-50's depth: the
JAX package's own two implementations of the op (pallas and reference,
both fp32) differ by many times the per-leaf 2e-3 * max(1, max |g|)
bound that ResNet-8 meets (test_torch_conv_epilogue.py), and chip_smoke.py
measures the same spread between fp32 and float64 runs of the port at
full width.  So the port is held to that spread: its distance from the
JAX pallas run (the norm of all leaves' errors over the norm of all
leaves, and the worst leaf's norm error over its own norm) may be at
most 3 times the JAX reference run's distance from it — for the step-1
gradients, the losses of every step, and the updates of every
persistable after three steps.  Later steps inherit the gradients'
spread and are chaotic, so those two checks bound only gross faults.

Run as a script (``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_resnet.py 1 2 3``), this file prints, for each batch
seed, the readings SPREAD sits between: the correct port's ratios, its
and the JAX runs' distances from a float64 run of the port by stage and
by op from the loss end, and the ratios of a port with a planted forward
fault (the batch-norm scale inv * (1 + d)).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jres = importlib.import_module("paddle_tpu.models.resnet")
tres = importlib.import_module("paddle_tpu_torch.models.resnet")

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.proto import ProgramDesc as JProgramDesc  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.proto import (  # noqa: E402
    ProgramDesc as TProgramDesc,
)

from test_torch_conv_epilogue import run_both, tce  # noqa: E402
from test_torch_program import canonical  # noqa: E402

SMALL = dict(depth=50, class_num=10, img_shape=(3, 64, 64))
LR, MOMENTUM, BATCH, STEPS = 0.01, 0.9, 4, 3
SPREAD = 3.0  # the port may lie this many times as far from JAX as JAX does


def _build(fluid, guard, res, lr=LR, img_dtype=None, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        if img_dtype is not None:
            kw["img"] = fluid.layers.data("image", list(kw["img_shape"]),
                                          dtype=img_dtype)
        spec = res.resnet_imagenet(fuse_bn="conv", **kw)
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


# -- the programs ------------------------------------------------------------

@pytest.fixture(scope="module")
def programs():
    full = dict(depth=50, class_num=1000, img_shape=(3, 224, 224))
    return {pkg: _build(fluid, guard, res, lr=0.1, **full)
            for pkg, fluid, guard, res in (("jax", jfluid, jguard, jres),
                                           ("torch", tfluid, tguard, tres))}


@pytest.mark.parametrize("which", ["main", "startup"])
def test_resnet50_programs_match_op_by_op_and_var_by_var(programs, which):
    idx = 0 if which == "main" else 1
    want = canonical(programs["jax"][idx])["blocks"]
    got = canonical(programs["torch"][idx])["blocks"]
    assert len(got) == len(want) == 1
    assert len(got[0]["ops"]) == len(want[0]["ops"]) == (
        318 if which == "main" else 429)
    for i, (g, w) in enumerate(zip(got[0]["ops"], want[0]["ops"])):
        assert g == w, f"op {i} ({w['type']})"
    assert got[0]["vars"] == want[0]["vars"]


@pytest.mark.parametrize("which", ["main", "startup"])
def test_resnet50_canonical_fingerprints_are_equal(programs, which):
    idx = 0 if which == "main" else 1
    jd = JProgramDesc.from_dict(canonical(programs["jax"][idx]))
    td = TProgramDesc.from_dict(canonical(programs["torch"][idx]))
    assert td.fingerprint() == jd.fingerprint()


def test_resnet50_main_program_has_53_conv_ops(programs):
    ops = programs["torch"][0].desc.block(0).ops
    convs = [op for op in ops if op.type == "conv_bn_add_act"]
    assert len(convs) == 53
    assert sum(bool(op.inputs.get("Z")) for op in convs) == 16
    assert len(programs["torch"][3]) == 161


# -- the other two forms, and what the port does not run --------------------

@pytest.mark.parametrize("fuse_bn", [False, True])
def test_fuse_bn_forms_build_jax_descs(fuse_bn):
    """The unfused (conv2d, batch_norm, elementwise_add + relu) and fused
    (conv2d, fused_bn_add_act) forms of both builders, at their default
    sizes: main and startup descs equal to JAX's after uid
    canonicalisation."""
    for builder in ("resnet_imagenet", "resnet_cifar10"):
        built = []
        for fluid, guard, res in ((jfluid, jguard, jres),
                                  (tfluid, tguard, tres)):
            main, startup = fluid.Program(), fluid.Program()
            with guard(), fluid.program_guard(main, startup):
                spec = getattr(res, builder)(fuse_bn=fuse_bn)
                fluid.optimizer.MomentumOptimizer(
                    learning_rate=0.1, momentum=0.9).minimize(spec.loss)
            built.append((canonical(main), canonical(startup)))
        assert built[1] == built[0], builder
        ops = [op["type"] for op in built[1][0]["blocks"][0]["ops"]]
        assert "conv_bn_add_act" not in ops
        assert ops.count("conv2d") == ops.count(
            "fused_bn_add_act" if fuse_bn else "batch_norm") > 0


@pytest.mark.parametrize("attrs", [{"is_test": True},
                                   {"use_global_stats": True},
                                   {"groups": 2}])
def test_conv_bn_add_act_rule_raises_outside_train_mode_groups_1(attrs):
    from paddle_tpu_torch.core.registry import OpRegistry

    rule = OpRegistry.get("conv_bn_add_act").lower
    x = torch.zeros(1, 4, 8, 8)
    ins = {"X": [x], "Filter": [torch.zeros(4, 4 // attrs.get("groups", 1),
                                            1, 1)],
           "Scale": [torch.ones(4)], "Bias": [torch.zeros(4)],
           "Mean": [torch.zeros(4)], "Variance": [torch.ones(4)]}
    with pytest.raises(NotImplementedError):
        rule(None, ins, dict(attrs))


# (pooling_type, ksize, strides, paddings, exclusive, ceil_mode,
# global_pooling) on a [2, 3, 9, 9] input: ResNet's max 3x3/2 pad 1 and
# global average, then the other attrs the rule reads
_POOLS = {
    "max_3s2p1": ("max", 3, 2, 1, True, False, False),
    "avg_global": ("avg", 7, 1, 0, True, False, True),
    "max_global": ("max", 7, 1, 0, True, False, True),
    "avg_3s2p1_exclusive": ("avg", 3, 2, 1, True, False, False),
    "avg_3s2p1_inclusive": ("avg", 3, 2, 1, False, False, False),
    "max_3s2p0_ceil": ("max", 3, 2, 0, True, True, False),
    "avg_2s2p1_ceil_exclusive": ("avg", 2, 2, 1, True, True, False),
}


@pytest.mark.parametrize("case", sorted(_POOLS))
def test_pool2d_rule_matches_jax(case):
    from paddle_tpu.core.registry import OpRegistry as JRegistry

    from paddle_tpu_torch.core.registry import OpRegistry as TRegistry

    ptype, k, s, p, exclusive, ceil, glob = _POOLS[case]
    attrs = {"pooling_type": ptype, "ksize": [k, k], "strides": [s, s],
             "paddings": [p, p], "exclusive": exclusive, "ceil_mode": ceil,
             "global_pooling": glob}
    x = np.random.default_rng(5).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    want = np.asarray(JRegistry.get("pool2d").lower(
        None, {"X": [x]}, dict(attrs))["Out"][0])
    got = TRegistry.get("pool2d").lower(
        None, {"X": [torch.from_numpy(x)]}, dict(attrs))["Out"][0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -- three Momentum steps ----------------------------------------------------

@pytest.fixture(scope="module")
def resnet50():
    """Three steps of the JAX program under both conv_bn_add_act
    implementations and of the port's, from the JAX startup state."""
    jbuilt = _build(jfluid, jguard, jres, **SMALL)
    tbuilt = _build(tfluid, tguard, tres, **SMALL)
    batch = jbuilt[2].synthetic_batch(BATCH, seed=1)
    return run_both(jbuilt, tbuilt, batch, STEPS,
                    jax_impls=("pallas", "reference"))


def _distances(got, want):
    """(norm of all errors over norm of all leaves, worst leaf's norm
    error over its own norm floored at 1e-4 of the largest leaf's)."""
    norms = [float(np.linalg.norm(w)) for w in want]
    floor = 1e-4 * max(norms)
    errs = [float(np.linalg.norm(np.asarray(g, np.float64) - w))
            for g, w in zip(got, want)]
    total = np.sqrt(sum(e * e for e in errs)) / np.sqrt(sum(n * n
                                                            for n in norms))
    return float(total), max(e / max(n, floor) for e, n in zip(errs, norms))


def _within_spread(run, pick):
    want = pick(run["jax"])
    port = _distances(pick(run["torch"]), want)
    jax = _distances(pick(run["jax_reference"]), want)
    assert port[0] <= SPREAD * jax[0] and port[1] <= SPREAD * jax[1], (
        port, jax)


def test_resnet50_first_loss_matches_jax(resnet50):
    np.testing.assert_allclose(resnet50["torch"]["loss"][0],
                               resnet50["jax"]["loss"][0], rtol=2e-4)


def test_resnet50_moving_stats_match_jax_after_step_one(resnet50):
    stats = [n for n in resnet50["persist"] if ".mean_" in n or ".var_" in n]
    assert len(stats) == 2 * 53
    for name in stats:
        want = resnet50["jax"]["state1"][name]
        np.testing.assert_allclose(resnet50["torch"]["state1"][name], want,
                                   rtol=2e-4, atol=2e-4, err_msg=name)
        assert np.any(want != resnet50["state"][name]), name


def test_resnet50_grads_within_the_jax_package_spread(resnet50):
    _within_spread(resnet50, lambda run: run["grads"])


def test_resnet50_losses_within_the_jax_package_spread(resnet50):
    want = np.asarray(resnet50["jax"]["loss"])
    port = np.abs(np.asarray(resnet50["torch"]["loss"]) - want)
    jax = np.abs(np.asarray(resnet50["jax_reference"]["loss"]) - want)
    assert np.all(port <= SPREAD * jax + 2e-4 * np.abs(want)), (port, jax)
    assert np.all(np.isfinite(resnet50["torch"]["loss"]))


def test_resnet50_updates_within_the_jax_package_spread(resnet50):
    """Every persistable after three steps — parameters, velocities,
    moving means and variances — compared as its update from the start
    state, so the distance is not diluted by the parameters' size."""
    names, start = resnet50["persist"], resnet50["state"]
    _within_spread(resnet50, lambda run: [
        np.asarray(run["state"][n], np.float64) - start[n] for n in names])


def test_resnet50_cpu_run_launches_nothing(resnet50):
    before, after = resnet50["launches"]
    assert before == after
    assert resnet50["copies"] == 2 * STEPS


# -- the readings behind SPREAD ----------------------------------------------

def _op_of(name):
    """The op index of a gradient leaf (conv_bn_add_act_<i>), -1 for fc."""
    head = name.split(".")[0]
    return -1 if head.startswith("fc_") else int(head.rsplit("_", 1)[1])


def _stage(op):
    """ResNet-50's stage of op index ``op``: fc, res5 ... res2, stem."""
    for stage, last in (("fc", -1), ("stem", 0), ("res2", 10),
                        ("res3", 23), ("res4", 42)):
        if op <= last:
            return stage
    return "res5"


def _by(key, gnames, got, want):
    """Per group of leaves (``key`` of the op index), from the loss end:
    the norm of the group's errors over the norm of its leaves."""
    err, norm = {}, {}
    for n, g, w in sorted(zip(gnames, got, want), key=lambda t: (
            -_op_of(t[0]) if _op_of(t[0]) >= 0 else -1e9)):
        k = key(_op_of(n))
        err[k] = err.get(k, 0.0) + float(np.sum(
            (np.asarray(g, np.float64) - w) ** 2))
        norm[k] = norm.get(k, 0.0) + float(np.sum(np.square(w, dtype=float)))
    return {k: (err[k] / norm[k]) ** 0.5 for k in err}


def _port_run(main, state, batch, fetch):
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.load_state(state, scope)
    return exe.run(main, feed=batch, fetch_list=fetch, scope=scope)


def spread_readings(seed, faults=(1e-2, 1e-3)):
    """At the test size, the batch made from ``seed``: each fp32 run's
    step-1 gradient distances (all leaves, worst leaf) from the JAX
    pallas run, the port-over-JAX-reference ratios the tests gate at
    SPREAD, each run's distance from the port's float64 run, by stage and
    by op from the loss end; then the same ratios for the port with a
    planted forward fault: bn_epilogue's inv scaled by 1 + d (the
    backward still uses the true inv)."""
    jbuilt = _build(jfluid, jguard, jres, **SMALL)
    tbuilt = _build(tfluid, tguard, tres, **SMALL)
    batch = jbuilt[2].synthetic_batch(BATCH, seed=seed)
    run = run_both(jbuilt, tbuilt, batch, 1, jax_impls=("pallas",
                                                         "reference"))
    gnames, loss = run["gnames"], jbuilt[2].loss.name
    main64 = _build(tfluid, tguard, tres, img_dtype="float64", **SMALL)[0]
    exact = _port_run(main64, run["state"], {
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in batch.items()}, gnames)
    g = {k: run[k]["grads"] for k in ("jax", "jax_reference", "torch")}
    port, jax = _distances(g["torch"], g["jax"]), _distances(
        g["jax_reference"], g["jax"])
    out = {"seed": seed,
           "port_vs_jax_pallas": port, "jax_reference_vs_jax_pallas": jax,
           "ratio": (port[0] / jax[0], port[1] / jax[1]), "spread": SPREAD,
           "vs_float64": {k: _distances(v, exact) for k, v in g.items()},
           "vs_float64_by_stage": {k: _by(_stage, gnames, v, exact)
                                   for k, v in g.items()},
           "vs_float64_by_op": {k: _by(int, gnames, v, exact)
                                for k, v in g.items()},
           "faults": {}}
    plain = tce.bn_epilogue
    for d in faults:
        tce.bn_epilogue = (lambda o, mean, inv, *a, _d=d:
                           plain(o, mean, inv * (1.0 + _d), *a))
        try:
            vals = _port_run(tbuilt[0], run["state"], batch, [loss] + gnames)
        finally:
            tce.bn_epilogue = plain
        dist = _distances(vals[1:], g["jax"])
        out["faults"][f"inv*(1+{d:g})"] = {
            "loss_rel_err": abs(float(vals[0].reshape(-1)[0])
                                - run["jax"]["loss"][0])
            / abs(run["jax"]["loss"][0]),
            "ratio": (dist[0] / jax[0], dist[1] / jax[1])}
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resnet.py 1 2 3
    import json
    import sys

    for s in sys.argv[1:] or ["1"]:
        print(json.dumps(spread_readings(int(s))), flush=True)
