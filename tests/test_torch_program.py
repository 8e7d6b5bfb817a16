"""The port's Program front end (paddle_tpu_torch: layers, optimizer,
backward, op shape rules) against the JAX package's, on the CPU.

The same Transformer training program is built in both packages — the
model's layers, then MomentumOptimizer.minimize — and compared op by op
and var by var.  Raw ``ProgramDesc.fingerprint()``s cannot be compared:
append_backward numbers the ops it differentiates from a process-global
counter (``paddle_tpu/core/backward.py:26-34``, and its copy in the port),
so a build's ``__op_uid__`` / ``__fwd_op_uid__`` values depend on what the
process built before.  Both descs are compared after those uids are
renumbered by order of first appearance; the fingerprints of the
renumbered descs must then be equal too.
"""

import importlib
import json

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
from paddle_tpu.core.proto import ProgramDesc as JProgramDesc  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch import device as tdevice  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.compiler import (  # noqa: E402
    LoweringContext,
    run_block,
)
from paddle_tpu_torch.core.proto import ProgramDesc as TProgramDesc  # noqa: E402

# 2 layers, d_model 64, 4 heads, vocab 64, S 16: every op type of the
# full-width program at a size the CPU runs in seconds
SMALL = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
             n_layer=2, n_head=4, d_model=64, d_inner=128, dropout=0.0,
             use_flash_attention=True)
UID_ATTRS = ("__op_uid__", "__fwd_op_uid__")


def build(pkg, **cfg):
    """(main, startup, spec, params_grads) of the Transformer + Momentum,
    under fresh name counters."""
    fluid, guard, tr = ((jfluid, jguard, jtr) if pkg == "jax"
                        else (tfluid, tguard, ttr))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = tr.transformer(tr.TransformerConfig(**{**SMALL, **cfg}))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=1e-4, momentum=0.9).minimize(spec.loss)
    return main, startup, spec, params_grads


def canonical(program) -> dict:
    """The desc as JSON with op uids renumbered by first appearance."""
    d = json.loads(program.desc.serialize_to_string())
    uids = {}
    for block in d["blocks"]:
        for op in block["ops"]:
            for key in UID_ATTRS:
                if key in op["attrs"]:
                    op["attrs"][key] = uids.setdefault(op["attrs"][key],
                                                       len(uids) + 1)
    return d


@pytest.fixture(scope="module")
def programs():
    return {pkg: build(pkg) for pkg in ("jax", "torch")}


@pytest.mark.parametrize("which", ["main", "startup"])
def test_programs_match_op_by_op(programs, which):
    idx = 0 if which == "main" else 1
    want = canonical(programs["jax"][idx])["blocks"]
    got = canonical(programs["torch"][idx])["blocks"]
    assert len(got) == len(want) == 1
    assert len(got[0]["ops"]) == len(want[0]["ops"])
    for i, (g, w) in enumerate(zip(got[0]["ops"], want[0]["ops"])):
        assert g == w, f"op {i} ({w['type']})"


@pytest.mark.parametrize("which", ["main", "startup"])
def test_programs_match_var_by_var(programs, which):
    idx = 0 if which == "main" else 1
    want = canonical(programs["jax"][idx])["blocks"][0]["vars"]
    got = canonical(programs["torch"][idx])["blocks"][0]["vars"]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    if which == "main":  # parameters keep their tensor-parallel annotation
        assert want["enc_l0_attn_q_w"]["sharding"] == [None, "tp"]


@pytest.mark.parametrize("which", ["main", "startup"])
def test_canonical_fingerprints_are_equal(programs, which):
    idx = 0 if which == "main" else 1
    jd = JProgramDesc.from_dict(canonical(programs["jax"][idx]))
    td = TProgramDesc.from_dict(canonical(programs["torch"][idx]))
    assert td.fingerprint() == jd.fingerprint()


def test_raw_fingerprints_depend_on_uid_history():
    """Two builds of one model in one process: the uid counter has moved
    on, so the raw fingerprints differ and the canonical ones do not."""
    first, second = build("torch")[0], build("torch")[0]
    assert first.desc.fingerprint() != second.desc.fingerprint()
    assert (TProgramDesc.from_dict(canonical(first)).fingerprint()
            == TProgramDesc.from_dict(canonical(second)).fingerprint())


def test_training_program_has_the_expected_shape(programs):
    main, startup, _, params_grads = programs["torch"]
    ops = [op.type for op in main.desc.block(0).ops]
    n_attn = 3 * SMALL["n_layer"]
    assert ops.count("fused_attention") == n_attn
    assert ops.count("fused_attention_grad") == n_attn
    assert ops.count("momentum") == len(params_grads)
    assert {op.type for op in startup.desc.block(0).ops} == {
        "uniform_random", "assign_value", "fill_constant"}


def test_a_jax_built_program_runs_in_the_port():
    """The carry-across harness: the JAX package's main program,
    serialized and parsed by the port, runs on the port's executor from
    the JAX startup state and gives the JAX loss."""
    jmain, jstartup, jspec, _ = build("jax")
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    state = {n: np.asarray(jscope.find_var(n))
             for n, v in jstartup.desc.block(0).vars.items() if v.persistable}
    batch = jspec.synthetic_batch(3, seed=4)
    want, = jexe.run(jmain, feed=batch, fetch_list=[jspec.loss.name],
                     scope=jscope)

    tmain = tfluid.Program.parse_from_string(jmain.desc.serialize_to_string())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.load_state(state, tscope)
    got, = texe.run(tmain, feed=batch, fetch_list=[jspec.loss.name],
                    scope=tscope)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_executor_without_a_card_raises(monkeypatch):
    """Executor() is the card: with no card it raises, it never runs on
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tdevice.NoCudaDeviceError):
        tfluid.Executor()
    with pytest.raises(tdevice.NoCudaDeviceError):
        tfluid.Executor(tfluid.CUDAPlace(0))
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def test_main_before_startup_raises():
    main, _, spec, _ = build("torch")
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="run the startup program first"):
        exe.run(main, feed=spec.synthetic_batch(2), fetch_list=[spec.loss],
                scope=tfluid.Scope())


PORTED_OPTIONS = ("dropout", "fuse_qkv")


@pytest.mark.parametrize("option", [
    dict(dropout=0.1, use_recompute=True), dict(use_flash_attention=False),
    dict(fuse_qkv=True, fuse_smooth_ce=False), dict(use_recompute=True),
    dict(fuse_smooth_ce=False)])
def test_unported_model_options_raise(option):
    """An unported option raises, alone or beside a ported one, and the
    message names the unported options only."""
    with pytest.raises(NotImplementedError, match="not ported") as err:
        build("torch", **option)
    msg = str(err.value)
    assert all(k in msg for k in option if k not in PORTED_OPTIONS)
    assert not any(k in msg for k in PORTED_OPTIONS)


@pytest.mark.parametrize("option", [dict(dropout=0.1), dict(fuse_qkv=True)])
def test_ported_model_options_match_jax(option):
    """dropout > 0 (the dropout ops) and fuse_qkv (one projection and a
    split) build in both packages with equal canonical descs."""
    jprog, tprog = build("jax", **option), build("torch", **option)
    for idx in (0, 1):
        assert canonical(tprog[idx]) == canonical(jprog[idx])
    made = "dropout" if "dropout" in option else "split"
    assert made in [op.type for op in tprog[0].desc.block(0).ops]


def test_nesterov_momentum_raises():
    """Only plain momentum is ported: a parsed program that asks for
    Nesterov fails at its momentum op instead of updating another way."""
    main, startup, spec, _ = build("torch")
    for op in main.desc.block(0).ops:
        if op.type == "momentum":
            op.attrs["use_nesterov"] = True
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="Nesterov"):
        exe.run(main, feed=spec.synthetic_batch(2), fetch_list=[spec.loss],
                scope=scope)


@pytest.mark.parametrize("fetch_softmax", [False, True])
def test_softmax_output_is_made_only_when_read(fetch_softmax):
    """softmax_with_cross_entropy leaves its [*, V] Softmax out unless a
    later op or the caller reads it; when read it is softmax(logits)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tguard(), tfluid.program_guard(main, startup):
        logits = tfluid.layers.data("logits", [8])
        label = tfluid.layers.data("label", [1], dtype="int64")
        loss, softmax = tfluid.layers.softmax_with_cross_entropy(
            logits, label, return_softmax=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 8, (4, 1)))
    ctx = LoweringContext({"logits": x, "label": y}, torch.device("cpu"),
                          torch.Generator())
    keep = [loss.name] + ([softmax.name] if fetch_softmax else [])
    run_block(ctx, main.desc.block(0).ops, keep=keep)
    assert (softmax.name in ctx.env) == fetch_softmax
    if fetch_softmax:
        torch.testing.assert_close(ctx.env[softmax.name],
                                   torch.softmax(x, -1), rtol=1e-6,
                                   atol=1e-7)
    want = -torch.log_softmax(x, -1).gather(-1, y)
    torch.testing.assert_close(ctx.env[loss.name], want, rtol=1e-6,
                               atol=1e-6)
