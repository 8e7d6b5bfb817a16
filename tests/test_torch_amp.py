"""bf16 AMP in the port (paddle_tpu_torch) against the JAX package, on the
CPU: the bf16 flash plain versions, the AMP policy, the split and dropout
rules, and the Transformer that bench.py times (fuse_qkv, dropout 0.1)
built and trained under both AMP tiers.

Tolerances, and why:

- bf16 flash plain versions against the Pallas kernels in interpret mode
  (``force="interpret"``), on the same bf16 inputs.  Both compute in fp32
  and round at the same points (P per key tile, dS, dS^T, P^T, the
  outputs), so they differ only where fp32 summation order moves a value
  across a bf16 rounding boundary: one bf16 ulp, at most 2^-7 of the
  value.  Bounds: max abs error <= 2^-7 * max |JAX|, and at most 1% of
  the elements not bit-equal (a rounding point moved or dropped changes
  12-42% of them); lse within 1e-5 relative.  The same bounds hold the
  CUDA kernels against these plain versions on the card (chip_smoke.py).
  With the CUDA kernel's 64-key tile in place of the TPU kernel's 128,
  P rounds at another running max, and only the max bound is asked.
- Three Momentum steps under each tier against the JAX executor under the
  same tier, dropout 0.  On the CPU the JAX fused_attention takes
  ``_reference_attention`` (bf16 einsums and softmax) where the port's
  plain versions round at the Pallas kernel's points, and every bf16
  matmul rounds after another summation order; a bf16 activation that
  rounds the other way can turn a ReLU input across 0 (8 of 4096 did in
  one layer, carrying a 9% change of its gradients' norm).  So: each
  step's loss within 2^-6 relative (two bf16 ulps of a bf16 loss), each
  param@GRAD of step 1 within 25% of the JAX one's norm (measured at
  most 9%; a transposed or dropped term moves it by O(1)), and the dtype
  of every var the step produces equal to JAX's — the check that no
  activation chain is widened or narrowed.
"""

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# the JAX packages re-export functions named like their modules, so the
# modules are looked up by full name
jflash = importlib.import_module("paddle_tpu.kernels.flash_attention")
jtr = importlib.import_module("paddle_tpu.models.transformer")
ttr = importlib.import_module("paddle_tpu_torch.models.transformer")

import paddle_tpu as jfluid  # noqa: E402
from paddle_tpu.core import amp as jamp  # noqa: E402
from paddle_tpu.core.framework import unique_name_guard as jguard  # noqa: E402
from paddle_tpu.core.registry import OpRegistry as JOps  # noqa: E402
from paddle_tpu.core.scope import Scope as JScope  # noqa: E402

import paddle_tpu_torch as tfluid  # noqa: E402
from paddle_tpu_torch.core import amp as tamp  # noqa: E402
from paddle_tpu_torch.core.compiler import LoweringContext  # noqa: E402
from paddle_tpu_torch.core.framework import (  # noqa: E402
    unique_name_guard as tguard,
)
from paddle_tpu_torch.core.proto import DataType  # noqa: E402
from paddle_tpu_torch.core.registry import OpRegistry as TOps  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as tflash  # noqa: E402

BF16_ULP = 2.0 ** -7     # kernel vs plain: max abs err <= this * max |plain|
MISMATCH_SHARE = 0.01    # at most this share of elements not bit-equal
LSE_RTOL = 1e-5
LOSS_RTOL = 2.0 ** -6    # model steps: two bf16 ulps of the bf16 loss
GRAD_NORM_RTOL = 0.25    # model steps: |port - jax| <= this * |jax| per leaf

# -- the bf16 flash plain versions against Pallas interpret mode ----------

# (B, Sq, Sk, causal, k_lengths); H 2, D 64.  S off the TPU kernel's
# 128-row block (160: padded to 256), one block shorter than 128, Sq != Sk
# with bottom-right causal alignment, a fully masked row
FLASH_CASES = {
    "causal_160": (1, 160, 160, True, [160]),
    "noncausal_ragged_96": (1, 96, 96, False, [50]),
    "causal_cached_keys_64x150": (1, 64, 150, True, [120]),
    "masked_row_64": (2, 64, 64, False, [64, 0]),
}


def _bf16_inputs(seed, B, Sq, Sk):
    """q, k, v, dout as (jax bf16, torch bf16) pairs of the same values."""
    rng = np.random.RandomState(seed)
    out = []
    for S in (Sq, Sk, Sk, Sq):
        x = rng.standard_normal((B, 2, S, 64)).astype(np.float32)
        t = torch.from_numpy(x).to(torch.bfloat16)
        j = jnp.asarray(x).astype(jnp.bfloat16)
        assert np.array_equal(np.asarray(j, np.float32), t.float().numpy())
        out.append((j, t))
    return out


def _close(got, want, what):
    """The kernel-level bounds: max abs error and the share of elements
    that are not bit-equal."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= BF16_ULP * float(np.abs(want).max()), (what, err)
    share = float(np.mean(got != want))
    assert share <= MISMATCH_SHARE, (what, share)


@pytest.fixture(scope="module", params=sorted(FLASH_CASES))
def flash_case(request):
    """The JAX Pallas kernels in interpret mode on one case: out, lse and
    the three gradients, beside the torch inputs."""
    B, Sq, Sk, causal, lens = FLASH_CASES[request.param]
    (jq, q), (jk, k), (jv, v), (jdo, do) = _bf16_inputs(
        sorted(FLASH_CASES).index(request.param), B, Sq, Sk)
    scale = 64 ** -0.5
    klen = jnp.asarray(lens, jnp.float32)
    out, lse = jflash._pallas_flash(jq, jk, jv, klen, causal, scale,
                                    interpret=True, need_lse=True)
    lse = np.array(lse).reshape(B, 2, -1)[:, :, :Sq].copy()
    _, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(
        a, b, c, causal=causal, scale=scale, k_lengths=np.asarray(lens),
        force="interpret"), jq, jk, jv)
    grads = vjp(jdo)
    assert all(g.dtype == jnp.bfloat16 for g in (out, *grads))
    kl = torch.tensor(lens, dtype=torch.int32)
    return dict(q=q, k=k, v=v, do=do, kl=kl, causal=causal, scale=scale,
                Sk=Sk, out=np.asarray(out, np.float32), lse=lse,
                grads=[np.asarray(g, np.float32) for g in grads])


def test_bf16_plain_forward_matches_pallas_interpret(flash_case):
    c = flash_case
    out, lse = tflash.flash_attention_fwd_bf16_reference(
        c["q"], c["k"], c["v"], c["causal"], c["scale"], c["kl"],
        block_k=min(128, c["Sk"]))  # the TPU kernel's key block
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, c["out"], "out")
    np.testing.assert_allclose(lse.numpy(), c["lse"], rtol=LSE_RTOL)
    # the port's forward on the CPU: the CUDA kernel's 64-key tile
    got, got_lse = tflash.flash_attention_fwd(c["q"], c["k"], c["v"],
                                              c["causal"], c["scale"],
                                              c["kl"])
    err = float(np.abs(got.float().numpy() - c["out"]).max())
    assert err <= BF16_ULP * float(np.abs(c["out"]).max())
    np.testing.assert_allclose(got_lse.numpy(), c["lse"], rtol=LSE_RTOL)
    if 0 in c["kl"].tolist():  # a fully masked row: zeros, lse = +1e30
        row = c["kl"].tolist().index(0)
        assert bool((got[row] == 0).all())
        assert bool((got_lse[row] == -tflash.NEG_INF).all())


def test_bf16_plain_backward_matches_pallas_interpret(flash_case):
    c = flash_case
    # the JAX forward's out and lse, so that only the backward is compared
    grads = tflash.flash_attention_bwd_reference(
        c["q"], c["k"], c["v"], c["kl"],
        torch.from_numpy(c["out"]).to(torch.bfloat16),
        torch.from_numpy(c["lse"]), c["do"], c["causal"], c["scale"])
    for name, g, w in zip(("dq", "dk", "dv"), grads, c["grads"]):
        assert g.dtype == torch.bfloat16, name
        _close(g, w, name)


def test_bf16_autograd_through_the_wrapper(flash_case):
    """flash_attention's autograd on bf16 CPU tensors: the plain forward
    (64-key tiles) and backward, against the interpret-mode gradients at
    the max bound."""
    c = flash_case
    q, k, v = (c[n].clone().requires_grad_() for n in "qkv")
    out = tflash.flash_attention(q, k, v, causal=c["causal"],
                                 scale=c["scale"], k_lengths=c["kl"])
    grads = torch.autograd.grad(out, (q, k, v), c["do"])
    for name, g, w in zip(("dq", "dk", "dv"), grads, c["grads"]):
        assert g.dtype == torch.bfloat16, name
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= BF16_ULP * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("dtypes", [
    (torch.float16, torch.float16, torch.float16),
    (torch.float64, torch.float64, torch.float64),
    (torch.bfloat16, torch.float32, torch.bfloat16)])
def test_flash_refuses_other_and_mixed_dtypes(dtypes):
    q, k, v = (torch.zeros(1, 1, 4, 64, dtype=d) for d in dtypes)
    with pytest.raises(TypeError):
        tflash.flash_attention(q, k, v)


# -- the AMP policy --------------------------------------------------------

POLICIES = {"off": None, "bf16": False, "bf16_keep": True}
DTYPES = ("float32", "bfloat16", "int32")


def _names(xs):
    return [str(x.dtype).removeprefix("torch.") for x in xs]


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_amp_policy_matches_jax_dtype_for_dtype(policy):
    keep = POLICIES[policy]
    try:
        for amp in (jamp, tamp):
            if keep is None:
                amp.disable_amp()
            else:
                amp.enable_amp("bfloat16", keep_output=keep)
        want_dtype = jamp.amp_dtype()
        got_dtype = tamp.amp_dtype()
        assert ((got_dtype is None and want_dtype is None)
                or str(got_dtype) == f"torch.{want_dtype}")
        assert tamp.keep_output() == jamp.keep_output()
        for dx in DTYPES:
            jx, tx = jnp.zeros(2, dx), torch.zeros(2, dtype=getattr(torch, dx))
            assert (str(tamp.stats_dtype(tx)).removeprefix("torch.")
                    == jnp.dtype(jamp.stats_dtype(jx)).name)
            for dy in DTYPES:
                jy = jnp.zeros(2, dy)
                ty = torch.zeros(2, dtype=getattr(torch, dy))
                assert (_names(tamp.mxu_operands(tx, ty))
                        == _names(jamp.mxu_operands(jx, jy))), (dx, dy)
                assert (_names(tamp.match_kept(tx, ty))
                        == _names(jamp.match_kept(jx, jy))), (dx, dy)
                for do in DTYPES[:2]:  # a product's dtype, its operands'
                    jo = jnp.zeros(2, do)
                    to = torch.zeros(2, dtype=getattr(torch, do))
                    assert (_names([tamp.mxu_output(to, tx, ty)])
                            == _names([jamp.mxu_output(jo, jx, jy)])), (
                                do, dx, dy)
    finally:
        jamp.reset_amp()
        tamp.reset_amp()


def test_the_port_has_no_implicit_amp_default():
    tamp.reset_amp()
    assert tamp.amp_dtype() is None and not tamp.keep_output()
    with pytest.raises(ValueError):
        tamp.enable_amp("float32")


# -- split -----------------------------------------------------------------

SPLIT_CASES = {
    "num3_last_axis": ((4, 12), dict(num=3, sections=[], axis=-1)),
    "sections_axis1": ((4, 12), dict(num=0, sections=[2, 3, 7], axis=1)),
    "num2_axis0": ((6, 5), dict(num=2, sections=[], axis=0)),
    "sections_rank3": ((2, 5, 9), dict(num=0, sections=[4, 5], axis=2)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_matches_jax_values_and_grads(case):
    shape, attrs = SPLIT_CASES[case]
    rng = np.random.RandomState(sorted(SPLIT_CASES).index(case))
    x = rng.standard_normal(shape).astype(np.float32)

    def jsplit(a):
        return tuple(JOps.get("split").lower(None, {"X": [a]}, attrs)["Out"])

    want, vjp = jax.vjp(jsplit, jnp.asarray(x))
    gs = [rng.standard_normal(w.shape).astype(np.float32) for w in want]
    want_grad, = vjp(tuple(jnp.asarray(g) for g in gs))
    tx = torch.from_numpy(x).requires_grad_()
    got = TOps.get("split").lower(None, {"X": [tx]}, attrs)["Out"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    grad, = torch.autograd.grad(got, tx, [torch.from_numpy(g) for g in gs])
    np.testing.assert_array_equal(grad.numpy(), np.asarray(want_grad))


def test_split_refuses_an_unequal_num():
    with pytest.raises(ValueError, match="equal parts"):
        TOps.get("split").lower(None, {"X": [torch.zeros(4, 10)]},
                                dict(num=3, sections=[], axis=-1))


# -- dropout ---------------------------------------------------------------

class _JCtx:
    """What the JAX dropout rule reads of its lowering context."""

    is_test = False

    def rng(self):
        return jax.random.PRNGKey(0)


def _tdropout(x, seed=0, **attrs):
    ctx = LoweringContext({}, torch.device("cpu"),
                          torch.Generator().manual_seed(seed))
    return TOps.get("dropout").lower(ctx, {"X": [x]}, attrs)


IMPLS = ("downgrade_in_infer", "upscale_in_train")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["prob_0", "is_test"])
def test_dropout_deterministic_cases_equal_jax(mode, impl, dtype):
    attrs = dict(dropout_prob=0.0 if mode == "prob_0" else 0.3,
                 is_test=mode == "is_test", dropout_implementation=impl)
    x = np.random.RandomState(3).standard_normal((4, 33)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JOps.get("dropout").lower(_JCtx(), {"X": [jx]}, attrs)
    got = _tdropout(tx, **attrs)
    assert got["Out"][0].dtype == tx.dtype
    np.testing.assert_array_equal(got["Out"][0].float().numpy(),
                                  np.asarray(want["Out"][0], np.float32))
    np.testing.assert_array_equal(got["Mask"][0].numpy(),
                                  np.asarray(want["Mask"][0]))
    assert got["Mask"][0].dtype == torch.uint8


@pytest.mark.parametrize("impl", IMPLS)
def test_dropout_keep_fraction_and_grad(impl):
    p, n = 0.1, 100_000
    x = torch.randn(200, n // 200, generator=torch.Generator().manual_seed(1))
    x.requires_grad_()
    outs = _tdropout(x, seed=5, dropout_prob=p, is_test=False,
                     dropout_implementation=impl)
    out, mask = outs["Out"][0], outs["Mask"][0].bool()
    frac = float(mask.float().mean())
    assert abs(frac - (1 - p)) <= 5 * math.sqrt(p * (1 - p) / n), frac
    keep_scale = 1.0 if impl == "downgrade_in_infer" else 1.0 / (1 - p)
    torch.testing.assert_close(out, torch.where(mask, x * keep_scale, 0.0),
                               rtol=1e-6, atol=0)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    grad, = torch.autograd.grad(out, x, g)
    torch.testing.assert_close(grad, torch.where(mask, g * keep_scale, 0.0),
                               rtol=1e-6, atol=0)


def test_dropout_masks_follow_the_program_seed():
    """One program, random_seed 7 in two fresh scopes: the same masks,
    step for step; seed 8: other masks; the stream moves on each step."""

    def masks(seed):
        main, startup = tfluid.Program(), tfluid.Program()
        main.random_seed = seed
        with tguard(), tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", [64])
            tfluid.layers.dropout(x, dropout_prob=0.5)
        mask = [op.output("Mask")[0] for op in main.desc.block(0).ops
                if op.type == "dropout"]
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        feed = {"x": np.ones((8, 64), np.float32)}
        return [exe.run(main, feed=feed, fetch_list=mask, scope=scope)[0]
                for _ in range(2)]

    first, again, other = masks(7), masks(7), masks(8)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], first[1])
    assert not np.array_equal(first[0], other[0])


# -- bench.py's Transformer ------------------------------------------------

# bench.py:180-197 (fuse_qkv, flash, the config's dropout 0.1), cut to
# 2 + 2 layers, d_model 64, 4 heads, vocab 512, length 16
BENCH = dict(use_flash_attention=True, fuse_qkv=True)
SMALL = dict(BENCH, src_vocab_size=512, trg_vocab_size=512, max_length=16,
             n_layer=2, n_head=4, d_model=64, d_inner=128)
UID_ATTRS = ("__op_uid__", "__fwd_op_uid__")


def _build(pkg, lr=1e-4, **cfg):
    fluid, guard, tr = ((jfluid, jguard, jtr) if pkg == "jax"
                        else (tfluid, tguard, ttr))
    main, startup = fluid.Program(), fluid.Program()
    with guard(), fluid.program_guard(main, startup):
        spec = tr.transformer(tr.TransformerConfig(**cfg))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=lr, momentum=0.9).minimize(spec.loss)
    return main, startup, spec, params_grads


def _canonical(program) -> dict:
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


@pytest.mark.parametrize("width", ["reduced", "bench"])
def test_bench_transformer_descs_equal_jax(width):
    """bench.py's Transformer, dropout 0.1 and fuse_qkv, in both packages:
    main and startup descs equal op by op and var by var.  At bench's own
    width (vocab 32000, length 256, 6 + 6 layers) the main program has
    1193 ops."""
    cfg = SMALL if width == "reduced" else dict(
        BENCH, src_vocab_size=32000, trg_vocab_size=32000, max_length=256)
    jprog, tprog = _build("jax", **cfg), _build("torch", **cfg)
    for idx in (0, 1):
        want = _canonical(jprog[idx])["blocks"]
        got = _canonical(tprog[idx])["blocks"]
        assert len(got[0]["ops"]) == len(want[0]["ops"])
        for i, (g, w) in enumerate(zip(got[0]["ops"], want[0]["ops"])):
            assert g == w, f"op {i} ({w['type']})"
        assert got[0]["vars"] == want[0]["vars"]
    ops = [op.type for op in tprog[0].desc.block(0).ops]
    n = 3 * (2 if width == "reduced" else 6)
    assert ops.count("fused_attention") == ops.count("split") == n
    assert ops.count("dropout") == ops.count("dropout_grad") > 0
    if width == "bench":
        assert len(ops) == 1193
        assert (ops.count("dropout"), ops.count("matmul"),
                ops.count("layer_norm"), ops.count("momentum")) == (
                    62, 67, 30, 195)


TIERS = {"amp1": False, "keep": True}
STEPS, LR = 3, 0.1


def _produced(program):
    """Every var an op of block 0 writes, in order (XShape slots aside:
    the JAX lowering makes no value for them)."""
    names = []
    for op in program.desc.block(0).ops:
        for slot, ns in op.outputs.items():
            names += [n for n in ns
                      if slot != "XShape" and n and n not in names]
    return names


@pytest.fixture(scope="module", params=sorted(TIERS))
def tier_runs(request):
    """Three steps of the reduced bench Transformer (dropout 0, batch 2)
    in each package from the JAX startup state, under one AMP tier.  Step
    1 fetches every var the step produces, unconverted."""
    keep = TIERS[request.param]
    cfg = dict(SMALL, dropout=0.0)
    for amp in (jamp, tamp):
        amp.enable_amp("bfloat16", keep_output=keep)
    try:
        jmain, jstartup, jspec, jpg = _build("jax", lr=LR, **cfg)
        tmain, _, _, tpg = _build("torch", lr=LR, **cfg)
        jscope = JScope()
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstartup, scope=jscope)
        persist = sorted(n for n, v in jstartup.desc.block(0).vars.items()
                         if v.persistable)
        tscope = tfluid.Scope()
        texe = tfluid.Executor(tfluid.CPUPlace())
        texe.load_state({n: np.asarray(jscope.find_var(n)) for n in persist},
                        tscope)
        batch = jspec.synthetic_batch(2, seed=1)
        produced = _produced(jmain)
        gnames = [g.name for _, g in jpg]
        assert gnames == [g.name for _, g in tpg]
        before = tflash.flash_attention.launches
        out = {"loss": {"jax": [], "torch": []}, "produced": produced,
               "gnames": gnames, "block": tmain.desc.block(0), "keep": keep}
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
        out["launched"] = tflash.flash_attention.launches - before
        out["state_dtypes"] = {str(tscope.find_var(n).dtype)
                               for n in persist}
        return out
    finally:
        jamp.reset_amp()
        tamp.reset_amp()


def test_amp_losses_match_jax_and_fall(tier_runs):
    want, got = tier_runs["loss"]["jax"], tier_runs["loss"]["torch"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_amp_grads_match_jax_in_norm(tier_runs):
    assert len(tier_runs["gnames"]) > 50
    for name in tier_runs["gnames"]:
        want = np.asarray(tier_runs["jax"][name], np.float64)
        got = tier_runs["torch"][name].double().numpy()
        assert tier_runs["torch"][name].dtype == torch.float32, name
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= GRAD_NORM_RTOL, (name, rel)


def test_amp_every_var_has_jax_dtype(tier_runs):
    """The runtime dtype of each var the step produces equals the JAX
    one's, floating dtypes exactly; an int64 desc JAX holds as int32 (x64
    off), the port as declared."""
    block = tier_runs["block"]
    halves = 0
    for name in tier_runs["produced"]:
        want = str(np.asarray(tier_runs["jax"][name]).dtype)
        got = str(tier_runs["torch"][name].dtype).removeprefix("torch.")
        if want == "int32" and block.vars[name].dtype == DataType.INT64:
            want = "int64"
        assert got == want, name
        halves += got == "bfloat16"
    # under keep the activations between the matmuls are bf16 (Q/K/V
    # reach the flash kernels in bf16, layer_norm writes bf16); under
    # amp1 every matmul output is cast back to fp32
    ops = block.ops
    attn_in = [n for op in ops if op.type == "fused_attention"
               for slot in ("Q", "K", "V") for n in op.input(slot)]
    ln_out = [op.output("Y")[0] for op in ops if op.type == "layer_norm"]
    want = torch.bfloat16 if tier_runs["keep"] else torch.float32
    assert {tier_runs["torch"][n].dtype for n in attn_in + ln_out} == {want}
    assert (halves > 0) == tier_runs["keep"]


def test_amp_master_weights_stay_fp32_and_no_kernel_runs(tier_runs):
    assert tier_runs["state_dtypes"] == {"torch.float32"}
    assert tier_runs["launched"] == 0
