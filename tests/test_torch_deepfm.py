"""DeepFM on the port (paddle_tpu_torch) against the JAX package, on the
CPU: SelectedRows embedding gradients, lazy Adam, and the new ops.

At a small size (8 fields, vocab 1000, embed 4, hidden (16, 16), batch
16, ids that repeat inside a batch and across fields), under the
differential harness (the program built by ``paddle_tpu``, carried across
by ``serialize_to_string``, the JAX startup state loaded into the port's
scope), three Adam steps on three batches in three forms: lazy Adam over
sparse gradients (bench.py's), ``lazy_mode=False`` (the sparse gradient
made dense) and ``is_sparse=False``.  Tolerances (fp32 on both sides,
different summation orders): losses within 2e-4 relative; each step-1
gradient within 2e-3 of its max |JAX|; after three steps, what the steps
changed in each parameter and moment (the tables at their touched rows)
within 2e-3 of the largest change JAX made to it; rows no batch touched
bit-equal to their initial values.  Each new op's forward and
gradient within 1e-5 of the JAX rule's; ``merge`` against the JAX merge on
duplicate and padding ids; an all-padding gradient leaves the tables
bit-equal; ``run_steps`` on ``CPUPlace()`` bit-equal to K ``run`` calls.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.registry import OpRegistry as JOps  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402
from paddle_tpu.core.selected_rows import (  # noqa: E402
    SelectedRowsValue as JRows,
)

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core.compiler import (  # noqa: E402
    LoweringContext,
    run_block,
)
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.registry import OpRegistry as TOps  # noqa: E402
from paddle_tpu_torch.core.selected_rows import (  # noqa: E402
    SelectedRowsValue as TRows,
)

from test_torch_program import canonical  # noqa: E402

jdfm = importlib.import_module("paddle_tpu.models.deepfm")
tdfm = importlib.import_module("paddle_tpu_torch.models.deepfm")

SMALL = dict(num_fields=8, vocab_size=1000, embed_dim=4,
             hidden_sizes=(16, 16))
BATCH, STEPS, LR = 16, 3, 1e-2
TABLES = ("deepfm_w1", "deepfm_emb")
# form -> (lazy_mode, is_sparse)
FORMS = {"lazy": (True, True), "densified": (False, True),
         "dense": (True, False)}
OP_TOL = 1e-5


def build(pkg, form):
    """(main, startup, spec, params_grads) of DeepFM + Adam."""
    fluid, guard, model = ((jfluid, jguard, jdfm) if pkg == "jax"
                           else (tfluid, tguard, tdfm))
    lazy, sparse = FORMS[form]
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = model.deepfm(is_sparse=sparse, **SMALL)
        _, params_grads = fluid.optimizer.AdamOptimizer(
            learning_rate=LR, lazy_mode=lazy).minimize(spec.loss)
    return main, startup, spec, params_grads


def batches(spec):
    """Three batches whose ids repeat across samples and across fields."""
    out = []
    for seed in range(1, STEPS + 1):
        b = spec.synthetic_batch(BATCH, seed=seed)
        b["feat_ids"][1] = b["feat_ids"][0]
        b["feat_ids"][:, 3] = b["feat_ids"][:, 2]
        out.append(b)
    return out


def _within(got, want, name):
    """max |got - want| <= 2e-3 * max |want|, for one leaf."""
    err = float(np.abs(got - want).max())
    assert err <= 2e-3 * float(np.abs(want).max()), (name, err)


def _dense(g, height):
    """A fetched gradient as a dense numpy array (either package's
    SelectedRowsValue, with numpy members)."""
    if isinstance(g, JRows):
        out = np.zeros((height,) + g.rows.shape[1:], g.rows.dtype)
        keep = g.ids < height
        np.add.at(out, g.ids[keep], g.rows[keep])
        return out
    if isinstance(g, TRows):
        out = np.zeros((height,) + g.rows.shape[1:], g.rows.dtype)
        np.add.at(out, g.ids[g.live], g.rows[g.live])
        return out
    return np.asarray(g)


@pytest.fixture(scope="module", params=list(FORMS))
def runs(request):
    """Three steps in each package from the JAX startup state."""
    form = request.param
    main, startup, spec, pg = build("jax", form)
    jscope, jexe = JScope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = sorted(n for n, v in startup.desc.block(0).vars.items()
                     if v.persistable)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tmain = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.load_state(init, tscope)
    gnames = [g.name for _, g in pg]
    feeds = batches(spec)
    out = {"form": form, "init": init, "persist": persist, "gnames": gnames,
           "feeds": feeds, "loss": {"jax": [], "torch": []}}
    for step, feed in enumerate(feeds):
        fetch = [spec.loss.name] + (gnames if step == 0 else [])
        for pkg, exe, prog, scope in (("jax", jexe, main, jscope),
                                      ("torch", texe, tmain, tscope)):
            vals = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
            out["loss"][pkg].append(float(np.ravel(vals[0])[0]))
            if step == 0:
                out.setdefault("grads", {})[pkg] = vals[1:]
        if step == 0:
            out["after_1"] = {n: tscope.find_var(n).numpy().copy()
                              for n in persist}
    out["jax"] = {n: np.asarray(jscope.find_var(n)) for n in persist}
    out["torch"] = {n: tscope.find_var(n).numpy() for n in persist}
    return out


def _touched(feeds):
    return np.unique(np.concatenate([f["feat_ids"].ravel() for f in feeds]))


def _is_table_state(name):
    return name.startswith(TABLES) and "_pow_" not in name


@pytest.mark.parametrize("which", [0, 1], ids=["main", "startup"])
@pytest.mark.parametrize("form", list(FORMS))
def test_descs_match_jax(form, which):
    jprog, tprog = build("jax", form)[which], build("torch", form)[which]
    assert canonical(tprog) == canonical(jprog)
    if which == 0:
        grads = [op for op in tprog.desc.block(0).ops
                 if op.type == "lookup_table_grad"]
        assert len(grads) == 2
        assert all(op.attrs["is_sparse"] == FORMS[form][1] for op in grads)


def test_losses_match_jax(runs):
    np.testing.assert_allclose(runs["loss"]["torch"], runs["loss"]["jax"],
                               rtol=2e-4)


def test_step_one_gradients_match_jax(runs):
    sparse = FORMS[runs["form"]][1]
    for name, got, want in zip(runs["gnames"], runs["grads"]["torch"],
                               runs["grads"]["jax"]):
        is_table = name.startswith(TABLES)
        assert isinstance(got, TRows) == (sparse and is_table), name
        height = runs["init"][name[:-len("@GRAD")]].shape[0]
        g, w = _dense(got, height), _dense(want, height)
        assert g.shape == w.shape, name
        _within(g, w, name)


def test_parameters_and_moments_match_jax_after_three_steps(runs):
    touched = _touched(runs["feeds"])
    moved = 0
    for name in runs["persist"]:
        init = runs["init"][name]
        got, want = runs["torch"][name] - init, runs["jax"][name] - init
        if _is_table_state(name):
            got, want = got[touched], want[touched]
        _within(got, want, name)
        moved += "moment" in name and bool(np.any(want != 0))
    assert moved == 16  # both moments of eight parameters


def test_untouched_rows_keep_their_initial_values(runs):
    untouched = np.setdiff1d(np.arange(SMALL["vocab_size"]),
                             _touched(runs["feeds"]))
    assert len(untouched) > 500
    for name in runs["persist"]:
        if _is_table_state(name):
            for pkg in ("torch", "jax"):
                np.testing.assert_array_equal(
                    runs[pkg][name][untouched],
                    runs["init"][name][untouched], err_msg=f"{pkg} {name}")


def test_lazy_rows_of_the_first_batch_only_keep_their_moments(runs):
    """Rows the first batch touched and the later ones did not: under
    lazy Adam their moments stay as step 1 left them; densified, they
    decay at every step."""
    first = np.unique(runs["feeds"][0]["feat_ids"])
    only_first = np.setdiff1d(first, _touched(runs["feeds"][1:]))
    assert len(only_first) > 50
    lazy = runs["form"] == "lazy"
    for table in TABLES:
        name = f"{table}_moment1_0"
        after_1 = runs["after_1"][name][only_first]
        final = runs["torch"][name][only_first]
        assert np.any(after_1 != 0)
        if lazy:
            np.testing.assert_array_equal(final, after_1, err_msg=name)
        else:
            np.testing.assert_allclose(final, 0.81 * after_1, rtol=1e-5,
                                       err_msg=name)


def test_run_steps_equals_stepwise_run_bit_for_bit():
    main, startup, spec, _ = build("torch", "lazy")
    feeds = batches(spec)
    states = []
    for stepwise in (True, False):
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        if stepwise:
            for feed in feeds:
                loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                                scope=scope)
        else:
            loss, = exe.run_steps(main, feed_list=feeds,
                                  fetch_list=[spec.loss], scope=scope)
        states.append((loss, {n: scope.find_var(n).numpy()
                              for n, v in startup.desc.block(0).vars.items()
                              if v.persistable}))
    (want, want_state), (got, got_state) = states
    np.testing.assert_array_equal(got, want)
    assert sorted(got_state) == sorted(want_state)
    for name in want_state:
        np.testing.assert_array_equal(got_state[name], want_state[name],
                                      err_msg=name)


def test_grad_rule_replaces_the_replay_and_stashes_nothing():
    """lookup_table_grad runs its registered rule: the table gradients
    are SelectedRowsValues, and no autograd graph of a lookup_table (nor
    of any op, after its grad op ran) is left in the stash."""
    main, startup, spec, _ = build("torch", "lazy")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    env = {n: scope.find_var(n) for n, v in main.desc.block(0).vars.items()
           if v.persistable and scope.find_var(n) is not None}
    env.update({k: torch.from_numpy(v)
                for k, v in batches(spec)[0].items()})
    ctx = LoweringContext(env, torch.device("cpu"), torch.Generator())
    keep = [f"{t}@GRAD" for t in TABLES]
    run_block(ctx, main.desc.block(0).ops, keep=keep)
    assert ctx.stash == {}
    for name in keep:
        g = ctx.env[name]
        assert isinstance(g, TRows) and g.rows.shape[0] == BATCH * 8


def test_a_table_looked_up_twice_sums_its_sparse_gradients():
    """Two lookups of one sparse table: append_backward sums the two
    gradients (the ``sum`` op concatenates their slots, one with padding),
    and lazy Adam over the sum matches JAX for two steps."""
    main, startup = jfluid.Program(), jfluid.Program()
    with jguard(), jfluid.program_guard(main, startup):
        layers = jfluid.layers
        a = layers.data("a", [3], dtype="int64")
        b = layers.data("b", [2], dtype="int64")
        ea = layers.embedding(a, size=[50, 4], is_sparse=True,
                              param_attr="tbl")
        eb = layers.embedding(b, size=[50, 4], is_sparse=True,
                              param_attr="tbl", padding_idx=7)
        loss = layers.elementwise_add(layers.mean(layers.square(ea)),
                                      layers.mean(layers.sigmoid(eb)))
        jfluid.optimizer.AdamOptimizer(learning_rate=0.1,
                                       lazy_mode=True).minimize(loss)
    assert "sum" in [op.type for op in main.desc.block(0).ops]
    jscope, jexe = JScope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(startup, scope=jscope)
    persist = sorted(n for n, v in startup.desc.block(0).vars.items()
                     if v.persistable)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    tmain = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.load_state(init, tscope)
    rng = np.random.default_rng(0)
    for _ in range(2):
        feed = {"a": rng.integers(0, 50, (4, 3)),
                "b": np.concatenate([rng.integers(0, 50, (4, 1)),
                                     np.full((4, 1), 7)], axis=1)}
        want, = jexe.run(main, feed=feed, fetch_list=[loss.name],
                         scope=jscope)
        got, = texe.run(tmain, feed=feed, fetch_list=[loss.name],
                        scope=tscope)
        np.testing.assert_allclose(got, want, rtol=2e-4)
    for name in persist:
        want = np.asarray(jscope.find_var(name)) - init[name]
        got = tscope.find_var(name).numpy() - init[name]
        _within(got, want, name)
    np.testing.assert_array_equal(tscope.find_var("tbl").numpy()[7],
                                  init["tbl"][7])


# -- the new ops against the JAX rules ---------------------------------------
def _run_both(op, arrays, attrs, diff, out="Out"):
    """(port, JAX) forward outputs and gradients of ``diff`` inputs under
    one random cotangent, for a rule with inputs ``{slot: array}``."""
    rng = np.random.default_rng(7)

    def jfn(*xs):
        ins = {k: [jnp.asarray(v)] for k, v in arrays.items()}
        ins.update({k: [x] for k, x in zip(diff, xs)})
        return JOps.get(op).lower(None, ins, dict(attrs))[out][0]

    jout, vjp = jax.vjp(jfn, *[jnp.asarray(arrays[k]) for k in diff])
    ct = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))

    leaves = {k: torch.from_numpy(arrays[k]).requires_grad_() for k in diff}
    ins = {k: [leaves.get(k, torch.from_numpy(v))]
           for k, v in arrays.items()}
    tout = TOps.get(op).lower(None, ins, dict(attrs))[out][0]
    tgrads = torch.autograd.grad(tout, [leaves[k] for k in diff],
                                 torch.from_numpy(ct))
    return ((tout.detach().numpy(), [g.numpy() for g in tgrads]),
            (np.asarray(jout), [np.asarray(g) for g in jgrads]))


_RNG = np.random.default_rng(3)
_X = _RNG.standard_normal((4, 3, 5)).astype(np.float32) * 3
_LABEL = _RNG.integers(0, 2, (6, 1)).astype(np.float32)
_LABEL[2, 0] = -100.0  # ignore_index
OP_CASES = {
    "square": ({"X": _X}, {}, ["X"]),
    "sigmoid": ({"X": _X}, {}, ["X"]),
    "elementwise_sub": ({"X": _X, "Y": _RNG.standard_normal((4, 3, 5))
                         .astype(np.float32)}, {"axis": -1}, ["X", "Y"]),
    "elementwise_sub_axis": ({"X": _X, "Y": _RNG.standard_normal(3)
                              .astype(np.float32)}, {"axis": 1},
                             ["X", "Y"]),
    "sigmoid_cross_entropy_with_logits": (
        {"X": _RNG.standard_normal((6, 1)).astype(np.float32) * 4,
         "Label": _LABEL}, {"ignore_index": -100}, ["X"]),
}


@pytest.mark.parametrize("case", list(OP_CASES))
def test_new_op_forward_and_gradient_match_jax(case):
    arrays, attrs, diff = OP_CASES[case]
    op = case.removesuffix("_axis")
    (tout, tgrads), (jout, jgrads) = _run_both(op, arrays, attrs, diff)
    np.testing.assert_allclose(tout, jout, rtol=OP_TOL, atol=OP_TOL)
    for name, g, w in zip(diff, tgrads, jgrads):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=OP_TOL, atol=OP_TOL,
                                   err_msg=name)


HEIGHT, DIM = 40, 3


def _table_grads(ids, padding_idx, is_sparse, seed=0):
    """The lookup_table_grad rule of each package on the same inputs."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((HEIGHT, DIM)).astype(np.float32)
    og = rng.standard_normal(ids.shape + (DIM,)).astype(np.float32)
    attrs = {"is_sparse": is_sparse, "padding_idx": padding_idx}
    jg = JOps.get("lookup_table_grad").lower(
        None, {"W": [jnp.asarray(w)], "Ids": [jnp.asarray(ids)],
               "Out@GRAD": [jnp.asarray(og)]}, attrs)["W@GRAD"][0]
    tg = TOps.get("lookup_table_grad").lower(
        None, {"W": [torch.from_numpy(w)], "Ids": [torch.from_numpy(ids)],
               "Out@GRAD": [torch.from_numpy(og)]}, attrs)["W@GRAD"][0]
    return tg, jg


_IDS = np.array([[5, 9, 5, 0], [9, 39, 5, 7], [3, 3, 3, 3]], np.int64)
TABLE_CASES = {"duplicates": (_IDS, -1), "padding": (_IDS, 3),
               "padding_0": (_IDS, 0), "all_padding": (np.full_like(_IDS, 3),
                                                       3)}


@pytest.mark.parametrize("is_sparse", [True, False],
                         ids=["sparse", "dense"])
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_lookup_table_grad_matches_jax(case, is_sparse):
    tg, jg = _table_grads(*TABLE_CASES[case], is_sparse)
    assert isinstance(tg, TRows) == is_sparse
    got = tg.to_dense() if is_sparse else tg
    want = jg.to_dense() if is_sparse else jg
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL,
                               atol=OP_TOL)


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_merge_matches_jax(case):
    """The merged value's live (id, row) pairs equal the JAX merge's, each
    id live once; every other slot carries the id and row of a live slot,
    and every id is in range."""
    tg, jg = _table_grads(*TABLE_CASES[case], True)
    tm, jm = tg.merge(), jg.merge()
    ids, rows, live = tm.ids.numpy(), tm.rows.numpy(), tm.live.numpy()
    jids, jrows = np.asarray(jm.ids), np.asarray(jm.rows)
    jlive = jids < HEIGHT
    order = np.argsort(ids[live])
    np.testing.assert_array_equal(ids[live][order], np.sort(jids[jlive]))
    np.testing.assert_allclose(rows[live][order],
                               jrows[jlive][np.argsort(jids[jlive])],
                               rtol=OP_TOL, atol=OP_TOL)
    assert ((ids >= 0) & (ids < HEIGHT)).all()
    by_id = dict(zip(ids[live], rows[live]))
    for i, r in zip(ids, rows):
        if by_id:
            np.testing.assert_array_equal(r, by_id[i])
    np.testing.assert_allclose(tm.to_dense().numpy(),
                               np.asarray(jm.to_dense()), rtol=OP_TOL,
                               atol=OP_TOL)


def _adam_both(case, lazy):
    """One adam op of each package on a table's sparse gradient."""
    tg, jg = _table_grads(*TABLE_CASES[case], True, seed=1)
    rng = np.random.default_rng(2)
    state = {"Param": rng.standard_normal((HEIGHT, DIM)),
             "Moment1": rng.standard_normal((HEIGHT, DIM)) * 0.1,
             "Moment2": rng.random((HEIGHT, DIM)) * 0.01,
             "Beta1Pow": np.array([0.9 ** 3]),
             "Beta2Pow": np.array([0.999 ** 3]),
             "LearningRate": np.array([0.1])}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "lazy_mode": lazy}
    jout = JOps.get("adam").lower(
        None, {"Grad": [jg], **{k: [jnp.asarray(v)]
                                for k, v in state.items()}}, attrs)
    tout = TOps.get("adam").lower(
        None, {"Grad": [tg], **{k: [torch.from_numpy(v)]
                                for k, v in state.items()}}, attrs)
    return state, ({k: v[0].numpy() for k, v in tout.items()},
                   {k: np.asarray(v[0]) for k, v in jout.items()})


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "densified"])
@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_adam_matches_jax(case, lazy):
    state, (got, want) = _adam_both(case, lazy)
    assert sorted(got) == sorted(want)
    for slot in want:
        np.testing.assert_allclose(got[slot], want[slot], rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=slot)
    if lazy:  # rows no live id names are bit-equal to before
        ids, pad = TABLE_CASES[case]
        live = np.unique(ids[ids != pad])
        rest = np.setdiff1d(np.arange(HEIGHT), live)
        for slot in ("Param", "Moment1", "Moment2"):
            np.testing.assert_array_equal(got[slot + "Out"][rest],
                                          state[slot][rest], err_msg=slot)


def test_all_padding_gradient_leaves_the_tables_bit_equal():
    state, (got, want) = _adam_both("all_padding", True)
    for slot in ("Param", "Moment1", "Moment2"):
        np.testing.assert_array_equal(got[slot + "Out"], state[slot])
        np.testing.assert_array_equal(want[slot + "Out"], state[slot])
    np.testing.assert_allclose(got["Beta1PowOut"], state["Beta1Pow"] * 0.9,
                               rtol=1e-7)


def test_momentum_takes_a_sparse_gradient_dense():
    """Momentum makes a SelectedRowsValue gradient dense, as the JAX rule
    does without lazy_mode (MomentumOptimizer never sets it)."""
    tg, jg = _table_grads(*TABLE_CASES["padding"], True, seed=1)
    rng = np.random.default_rng(4)
    state = {"Param": rng.standard_normal((HEIGHT, DIM)).astype(np.float32),
             "Velocity": rng.standard_normal((HEIGHT, DIM))
             .astype(np.float32),
             "LearningRate": np.array([0.1], np.float32)}
    attrs = {"mu": 0.9, "use_nesterov": False}
    jout = JOps.get("momentum").lower(
        None, {"Grad": [jg], **{k: [jnp.asarray(v)]
                                for k, v in state.items()}}, attrs)
    tout = TOps.get("momentum").lower(
        None, {"Grad": [tg], **{k: [torch.from_numpy(v)]
                                for k, v in state.items()}}, attrs)
    for slot in ("ParamOut", "VelocityOut"):
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=slot)
