"""``Executor.run_steps`` of the port on the CPU, against K calls of its
own ``run`` and against the JAX executor's ``run_steps``.

On ``CPUPlace()`` run_steps runs the block K times eagerly, so against
``run`` it must be bit-equal (the last loss, every parameter and
velocity, the random stream); the card's CUDA-graph path is held to the
same by ``chip_smoke.py``'s ``run_steps_training`` phase.  Against the
JAX package, under the differential harness (a program built by
``paddle_tpu``, carried across by ``serialize_to_string``, the reference
startup state loaded with ``load_state``, dropout 0): the last loss
within 2e-4, every parameter and velocity within 2e-3 (fp32 on both
sides, different summation orders).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

jtr = importlib.import_module("paddle_tpu.models.transformer")

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core.compiler import LoweringContext  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.proto import DataType  # noqa: E402
from paddle_tpu_torch.core.selected_rows import (  # noqa: E402
    SelectedRowsValue,
)
from paddle_tpu_torch.kernels import conv_epilogue as tconv  # noqa: E402
from paddle_tpu_torch.kernels import counters  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402
from paddle_tpu_torch.layer_helper import LayerHelper  # noqa: E402

STEPS, N_FEEDS = 7, 3


def _mlp():
    """fc, relu, dropout(0.3), mean and Momentum: (main, startup, loss)."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tguard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [8], dtype="float32")
        h = tfluid.layers.relu(tfluid.layers.fc(x, 16))
        h = tfluid.layers.dropout(h, 0.3)
        loss = tfluid.layers.mean(tfluid.layers.fc(h, 4))
        tfluid.optimizer.MomentumOptimizer(
            learning_rate=0.1, momentum=0.9).minimize(loss)
    main.random_seed = 7
    return main, startup, loss


def _feeds(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((5, 8)).astype(np.float32)}
            for _ in range(n)]


def _state(main, scope):
    block = main.desc.block(0)
    return {n: scope.find_var(n).numpy() for n, v in block.vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _started(startup):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, scope


def _assert_states_equal(got, want):
    assert sorted(got) == sorted(want)
    assert any(n.endswith("_velocity_0") for n in want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("mode", ["scan", "flat"])
def test_run_steps_equals_stepwise_run_bit_for_bit(mode):
    """7 steps over 3 feeds: the last loss, every parameter and velocity
    and the random stream as 7 calls of run, bit for bit."""
    main, startup, loss = _mlp()
    feeds = _feeds(N_FEEDS)
    exe, scope = _started(startup)
    for i in range(STEPS):
        want, = exe.run(main, feed=feeds[i % N_FEEDS], fetch_list=[loss],
                        scope=scope)
    exe2, scope2 = _started(startup)
    got, = exe2.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          steps=STEPS, scope=scope2, mode=mode)
    np.testing.assert_array_equal(got, want)
    _assert_states_equal(_state(main, scope2), _state(main, scope))
    assert torch.equal(scope2.find_var("@rng_key@").get_state(),
                       scope.find_var("@rng_key@").get_state())


def test_run_steps_defaults_to_one_step_a_feed():
    main, startup, loss = _mlp()
    feeds = _feeds(N_FEEDS, seed=1)
    exe, scope = _started(startup)
    for feed in feeds:
        want, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe2, scope2 = _started(startup)
    got, = exe2.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          scope=scope2)
    np.testing.assert_array_equal(got, want)
    _assert_states_equal(_state(main, scope2), _state(main, scope))


def test_run_and_run_steps_interleaved_equal_stepwise_run():
    """run, run_steps(2), run, run_steps(3): seven steps, as seven runs."""
    main, startup, loss = _mlp()
    feeds = _feeds(N_FEEDS, seed=2)
    exe, scope = _started(startup)
    order = [0, 0, 1, 1, 0, 1, 2]  # the feed index of each step
    for i in order:
        want, = exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope)
    exe2, scope2 = _started(startup)
    exe2.run(main, feed=feeds[0], fetch_list=[loss], scope=scope2)
    exe2.run_steps(main, feed_list=feeds[:2], fetch_list=[loss], steps=2,
                   scope=scope2)
    exe2.run(main, feed=feeds[1], fetch_list=[loss], scope=scope2)
    got, = exe2.run_steps(main, feed_list=feeds, fetch_list=[loss],
                          steps=3, scope=scope2)
    np.testing.assert_array_equal(got, want)
    _assert_states_equal(_state(main, scope2), _state(main, scope))


def _uniform_program(shape=(4,)):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        helper = LayerHelper("uniform_random")
        out = helper.create_variable_for_type_inference(DataType.FP32)
        helper.append_op(type="uniform_random", outputs={"Out": [out]},
                         attrs={"shape": list(shape),
                                "dtype": int(DataType.FP32),
                                "min": 0.0, "max": 1.0, "seed": 0})
    return main, out


def test_run_steps_advances_the_random_stream_across_calls():
    """Two run_steps(steps=2) calls draw differently, and the second
    call's output is the fourth eager draw."""
    main, out = _uniform_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    draws = [exe.run(main, fetch_list=[out], scope=scope)[0]
             for _ in range(4)]
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    scope2 = tfluid.Scope()
    a, = exe2.run_steps(main, feed_list=[{}], fetch_list=[out], steps=2,
                        scope=scope2)
    b, = exe2.run_steps(main, feed_list=[{}], fetch_list=[out], steps=2,
                        scope=scope2)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, draws[1])
    np.testing.assert_array_equal(b, draws[3])


def test_run_steps_value_errors():
    main, startup, loss = _mlp()
    exe, scope = _started(startup)
    feeds = _feeds(2)
    with pytest.raises(ValueError, match="non-empty feed_list"):
        exe.run_steps(main, feed_list=[], fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="steps >= 1"):
        exe.run_steps(main, feed_list=feeds, fetch_list=[loss], steps=0,
                      scope=scope)
    with pytest.raises(ValueError, match="differ"):
        exe.run_steps(main, feed_list=[feeds[0], {"y": feeds[1]["x"]}],
                      fetch_list=[loss], scope=scope)
    with pytest.raises(ValueError, match="mode"):
        exe.run_steps(main, feed_list=feeds, fetch_list=[loss], scope=scope,
                      mode="unrolled")
    # nothing ran
    _assert_states_equal(_state(main, scope), _state(main, _started(
        startup)[1]))


def _reshaped_feeds(rows):
    """Two feeds of x, [5, 8] and [rows, 8]."""
    first = _feeds(1)[0]
    return [first, {"x": first["x"][:rows].copy()}]


@pytest.mark.parametrize("rows", [3, 1])
def test_run_steps_feeds_of_other_shapes_raise_before_any_step(rows):
    """A feed whose shape differs from feed_list[0]'s raises ValueError
    before any step runs, as the JAX run_steps's stacking does (a [1, 8]
    feed would otherwise broadcast into the card's [5, 8] buffer)."""
    main, startup, loss = _mlp()
    exe, scope = _started(startup)
    before = _state(main, scope)
    with pytest.raises(ValueError, match="shape"):
        exe.run_steps(main, feed_list=_reshaped_feeds(rows),
                      fetch_list=[loss], steps=2, scope=scope)
    _assert_states_equal(_state(main, scope), before)


def test_run_steps_sees_a_numpy_feed_refilled_in_place():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [2], dtype="float32")
        out = tfluid.layers.mean(x)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.ones((2, 2), np.float32)}
    a, = exe.run_steps(main, feed_list=[feed], fetch_list=[out], steps=1,
                       scope=tfluid.Scope())
    feed["x"][:] = 5.0  # the refill-the-buffer loading pattern
    b, = exe.run_steps(main, feed_list=[feed], fetch_list=[out], steps=1,
                       scope=tfluid.Scope())
    assert float(np.ravel(a)[0]) == 1.0
    assert float(np.ravel(b)[0]) == 5.0


def test_cpu_run_steps_launches_no_kernel():
    main, startup, loss = _mlp()
    exe, scope = _started(startup)
    before = counters.snapshot()
    exe.run_steps(main, feed_list=_feeds(2), fetch_list=[loss], steps=3,
                  scope=scope)
    assert counters.difference(before, counters.snapshot()) == {}


def test_counters_difference_and_add():
    """The executor's bookkeeping for replays: a difference of two
    snapshots, added back n times, moves every counter n times as far."""
    base = counters.snapshot()
    keys = {k[:3] for k in base}
    assert ("flash_attention", "flash_attention", "launches") in keys
    assert ("conv_epilogue", "conv_stats", "launches_by_shape") in keys
    assert ("conv_epilogue", "conv_bn_act", "layout_copies") in keys
    fwd_before = tflash.flash_attention.launches
    bf16_before = tflash.flash_bwd_dq.launches_by_dtype["bfloat16"]
    copies_before = tconv.conv_bn_act.layout_copies
    shape = (2, 8, 8, 3, 4, 3, 1, 1, "bfloat16")
    try:
        tflash.flash_attention.launches += 2
        tflash.flash_bwd_dq.launches_by_dtype["bfloat16"] += 1
        tconv.conv_stats.launches_by_shape[shape] += 3
        tconv.conv_bn_act.layout_copies += 1
        gained = counters.difference(base, counters.snapshot())
        assert gained == {
            ("flash_attention", "flash_attention", "launches"): 2,
            ("flash_attention", "flash_bwd_dq", "launches_by_dtype"):
                {"bfloat16": 1},
            ("conv_epilogue", "conv_stats", "launches_by_shape"):
                {shape: 3},
            ("conv_epilogue", "conv_bn_act", "layout_copies"): 1}
        counters.add(gained, 4)
        assert tflash.flash_attention.launches == fwd_before + 10
        assert (tflash.flash_bwd_dq.launches_by_dtype["bfloat16"]
                == bf16_before + 5)
        assert tconv.conv_stats.launches_by_shape[shape] == 15
        counters.add(counters.difference(base, counters.snapshot()), -1)
        assert counters.difference(base, counters.snapshot()) == {}
    finally:
        tflash.flash_attention.launches = fwd_before
        tflash.flash_bwd_dq.launches_by_dtype["bfloat16"] = bf16_before
        tconv.conv_bn_act.layout_copies = copies_before
        tconv.conv_stats.launches_by_shape.pop(shape, None)


def test_assign_value_builds_its_constant_once_per_executor():
    """assign_value's tensor is made once (a host copy cannot be captured
    into a CUDA graph) and read by every later run; its values are those
    of a fresh build."""
    ctx = LoweringContext({}, torch.device("cpu"), torch.Generator(), {})
    from paddle_tpu_torch.core.registry import OpRegistry

    rule = OpRegistry.get("assign_value").lower
    attrs = {"shape": [2, 3], "dtype": int(DataType.FP32),
             "fp32_values": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]}
    ctx.op = None
    first = rule(ctx, {}, attrs)["Out"][0]
    again = rule(ctx, {}, attrs)["Out"][0]
    assert again is first
    want = torch.as_tensor(np.asarray(attrs["fp32_values"], np.float64)
                           .reshape(2, 3)).to(torch.float32)
    assert first.dtype == torch.float32 and torch.equal(first, want)
    other = rule(ctx, {}, dict(attrs, fp32_values=[0.0] * 6))["Out"][0]
    assert other is not first and not torch.any(other)


# -- against the JAX executor's run_steps (the differential harness) --------
SMALL = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
             n_layer=2, n_head=4, d_model=64, d_inner=128, dropout=0.0,
             use_flash_attention=True)
LR, MOMENTUM, BATCH, JAX_STEPS = 0.1, 0.9, 4, 5


def test_run_steps_matches_the_jax_run_steps():
    """A 2-layer Transformer built by paddle_tpu, carried across, five
    steps over two feeds through both run_steps."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jguard(), jfluid.program_guard(main, startup):
        spec = jtr.transformer(jtr.TransformerConfig(**SMALL))
        jfluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(spec.loss)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = sorted(n for n, v in startup.desc.block(0).vars.items()
                     if v.persistable)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    feeds = [spec.synthetic_batch(BATCH, seed=s) for s in (1, 2)]

    tmain = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    texe.load_state(init, tscope)

    want, = jexe.run_steps(main, feed_list=feeds,
                           fetch_list=[spec.loss.name], steps=JAX_STEPS,
                           scope=jscope)
    got, = texe.run_steps(tmain, feed_list=feeds,
                          fetch_list=[spec.loss.name], steps=JAX_STEPS,
                          scope=tscope)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    moved = 0
    for name in persist:
        w = np.asarray(jscope.find_var(name))
        g = tscope.find_var(name).numpy()
        np.testing.assert_allclose(g, w, rtol=2e-3, atol=2e-3, err_msg=name)
        moved += name.endswith("_velocity_0") and bool(np.any(w != 0))
    assert moved > 20  # the velocities were carried and updated


def test_the_card_path_caches_its_captures_and_never_runs_eagerly(
        monkeypatch):
    """The card's dispatch, with the capture replaced by a stand-in on
    meta tensors: a repeated call replays the cached capture; other steps,
    mode, scope or AMP state, or an edited program, are captured anew;
    and a capture that fails raises without running a step."""
    from paddle_tpu_torch.core import executor as texec

    made = []

    class Capture:
        serves = texec._StepGraph.serves

        def __init__(self, exe, program, plan, staged, steps, mode, scope,
                     gen):
            if fail:
                raise RuntimeError("capture failed")
            made.append((steps, mode))
            self.fingerprint = program.desc.fingerprint()
            self.scope, self.gen, self.plan = scope, gen, plan
            assert all(t.device.type == "meta" for f in staged
                       for t in f.values())

        def run(self, exe, staged, scope):
            return list(fetched)

    main, startup, loss = _mlp()
    exe, scope = _started(startup)
    gen = torch.Generator()
    monkeypatch.setattr(texec, "_StepGraph", Capture)
    monkeypatch.setattr(exe, "device", torch.device("meta"))
    monkeypatch.setattr(exe, "_generator", lambda scope, program: gen)
    before = _state(main, scope)
    feeds = _feeds(2)
    fail = False
    fetched = [torch.zeros(1)]

    def call(**kw):
        args = dict(feed_list=feeds, fetch_list=[loss], steps=3,
                    scope=scope)
        args.update(kw)
        return exe.run_steps(main, **args)

    call()
    call()
    assert made == [(3, "scan")]
    call(steps=4)
    call(mode="flat")
    call(scope=tfluid.Scope())
    assert made == [(3, "scan"), (4, "scan"), (3, "flat"), (3, "scan")]
    tfluid.enable_amp("bfloat16", keep_output=True)
    try:
        call()
    finally:
        tfluid.disable_amp()
    assert len(made) == 5
    op = next(op for op in main.desc.block(0).ops if op.type == "dropout")
    op.attrs["dropout_prob"] = 0.4
    main.desc.bump()
    n_graphs = len(exe._graphs)
    call()
    assert len(made) == 6 and len(exe._graphs) == n_graphs
    fail = True
    with pytest.raises(RuntimeError, match="capture failed"):
        call(steps=5)
    _assert_states_equal(_state(main, scope), before)
    # feeds of differing shapes raise before anything is staged or captured
    for rows in (3, 1):
        with pytest.raises(ValueError, match="shape"):
            call(feed_list=_reshaped_feeds(rows), steps=6)
    assert len(made) == 6
    _assert_states_equal(_state(main, scope), before)
    # without return_numpy, each fetch is a copy of the static output, a
    # sparse gradient's members included
    fail = False
    sparse = SelectedRowsValue(torch.tensor([2, 0]), torch.ones(2, 3), 4,
                               torch.tensor([True, False]))
    fetched = [torch.zeros(1), sparse]
    _, got = call(return_numpy=False)
    assert isinstance(got, SelectedRowsValue) and got.height == 4
    for member in ("ids", "rows", "live"):
        want = getattr(sparse, member)
        assert getattr(got, member) is not want
        assert torch.equal(getattr(got, member), want)
