"""Training the Transformer through the port's fluid entry points against
the JAX package, on the CPU.

Both packages build the same program (layers, then
MomentumOptimizer.minimize), the JAX startup state is copied into the
port's scope (the two random streams differ), and three Momentum steps
run on one synthetic batch in each.  On the CPU the port's
fused_attention takes the plain flash forward and backward versions, and
every other op its torch rule; the JAX package differentiates its
reference attention under jax.vjp.

Tolerances (fp32 on both sides, different summation orders): the loss at
every step within 2e-4 relative, every param@GRAD after step 1 within
2e-3 of max(1, max |grad|), every parameter and velocity after step 3
within 2e-4.  A masking or layout fault moves these by O(1e-2) or more.
The learning rate is 0.1, not the chip run's 1e-4, so that three steps
move the parameters far enough for the last check to see the updates.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the JAX models package re-exports a function named like its module, so
# the model modules are looked up by full name
jtr = importlib.import_module("paddle_tpu.models.transformer")
ttr = importlib.import_module("paddle_tpu_torch.models.transformer")

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402

SMALL = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
             n_layer=2, n_head=4, d_model=64, d_inner=128, dropout=0.0,
             use_flash_attention=True)
LR, MOMENTUM, BATCH, STEPS = 0.1, 0.9, 4, 3


def _build(fluid, guard, tr):
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = tr.transformer(tr.TransformerConfig(**SMALL))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


@pytest.fixture(scope="module")
def runs():
    """Three steps in each package from the same state: per package, the
    losses, the step-1 gradients and the final persistables."""
    jmain, jstartup, jspec, jpg = _build(jfluid, jguard, jtr)
    tmain, _, tspec, tpg = _build(tfluid, tguard, ttr)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    persist = sorted(n for n, v in jstartup.desc.block(0).vars.items()
                     if v.persistable)
    tscope = tfluid.Scope()
    texe = tfluid.Executor(tfluid.CPUPlace())
    texe.load_state({n: np.asarray(jscope.find_var(n)) for n in persist},
                    tscope)
    batch = jspec.synthetic_batch(BATCH, seed=1)
    gnames = [g.name for _, g in jpg]
    assert gnames == [g.name for _, g in tpg]
    launches = (tflash.flash_attention.launches,
                tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    out = {"jax": {"loss": []}, "torch": {"loss": []}, "gnames": gnames,
           "persist": persist}
    for step in range(STEPS):
        fetch = [jspec.loss.name] + (gnames if step == 0 else [])
        for pkg, exe, main, scope in (("jax", jexe, jmain, jscope),
                                      ("torch", texe, tmain, tscope)):
            vals = exe.run(main, feed=batch, fetch_list=fetch, scope=scope)
            out[pkg]["loss"].append(float(np.asarray(vals[0]).reshape(-1)[0]))
            if step == 0:
                out[pkg]["grads"] = [np.asarray(v) for v in vals[1:]]
    out["jax"]["state"] = {n: np.asarray(jscope.find_var(n))
                           for n in persist}
    out["torch"]["state"] = {n: tscope.find_var(n).numpy() for n in persist}
    out["launches"] = (launches, (tflash.flash_attention.launches,
                                  tflash.flash_bwd_dq.launches,
                                  tflash.flash_bwd_dkv.launches))
    return out


def test_losses_match_at_every_step(runs):
    want, got = runs["jax"]["loss"], runs["torch"]["loss"]
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]  # and the steps train


def test_every_param_grad_matches_after_step_one(runs):
    assert len(runs["gnames"]) > 50
    for name, g, w in zip(runs["gnames"], runs["torch"]["grads"],
                          runs["jax"]["grads"]):
        assert g.shape == w.shape, name
        bound = 2e-3 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= bound, name


def test_every_persistable_matches_after_three_steps(runs):
    moved = 0
    for name in runs["persist"]:
        want, got = runs["jax"]["state"][name], runs["torch"]["state"][name]
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        moved += name.endswith("_velocity_0") and bool(np.any(want != 0))
    assert moved > 50  # the velocities were updated


def test_cpu_training_launches_no_kernel(runs):
    before, after = runs["launches"]
    assert before == after
