"""The port's program linter, kernel tier (paddle_tpu_torch/analysis) and the
two corpus kernels (paddle_tpu_torch/kernels/corpus.py) against the JAX
package's, on the CPU.

- Numerics: the JAX corpus programs run their Pallas kernels in TPU
  interpret mode (the module's ``capture_fn`` is monkeypatched to hand the
  bare function back; nothing in the JAX package changes) and the port's
  ``corpus_add`` / ``corpus_scale`` take their plain versions on the same
  numpy inputs.  Tolerance 0: an fp32 add and a multiplication by 2 round
  the same way in every implementation.
- Verdicts: each corpus program is flagged by its detector in both
  packages — ``broadcast-operand`` with the same bytes, and each package's
  one overflow detector against its own budget (the v5e core's VMEM, the
  H100 block's shared memory).
- The CUDA kernels and the card's refusal of an oversized tile are held
  by chip_smoke.py's ``analysis`` phase on the card.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from paddle_tpu import analysis as janalysis  # noqa: E402
from paddle_tpu_torch import analysis  # noqa: E402
from paddle_tpu_torch.analysis import kernels as akernels  # noqa: E402
from paddle_tpu_torch.device import NoCudaDeviceError  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import corpus as ck  # noqa: E402

jcorpus = importlib.import_module("paddle_tpu.analysis.corpus")
tcorpus = importlib.import_module("paddle_tpu_torch.analysis.corpus")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Spec = analysis.TensorSpec

# the JAX detector id -> the port's, for the two corpus programs
PORT_DETECTOR = {"broadcast-operand": "broadcast-operand",
                 "vmem-overflow": "shared-memory-overflow"}


def _normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _skip_if_no_topology():
    try:
        from paddle_tpu.core.aot_tpu import tpu_topology

        tpu_topology()
    except Exception as e:  # pragma: no cover - environment-dependent
        pytest.skip(f"no chip-less TPU topology available: {e}")


def _jax_corpus_fn(monkeypatch, name):
    """The JAX corpus program's bare function (its builder with capture_fn
    handing the function back instead of compiling it)."""
    monkeypatch.setattr(jcorpus, "capture_fn", lambda fn, *a, **k: fn)
    return jcorpus.CORPUS[name][0]()


def _scale_program(tile_rows, shape=(2, 4096, 4096)):
    return analysis.capture_fn(lambda x: ck.corpus_scale(x, tile_rows),
                               Spec(shape), name=f"scale_tile_{tile_rows}")


# ---------------------------------------------------------------------------
# kernel numerics against the Pallas kernels in interpret mode


def test_corpus_add_equals_the_pallas_kernel(monkeypatch):
    rng = np.random.default_rng(0)
    x, lse = _normal(rng, 512, 128), _normal(rng, 512)
    fn = _jax_corpus_fn(monkeypatch, "broadcast_lse")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(x, lse))
    tx, tl = torch.from_numpy(x), torch.from_numpy(lse)
    got = ck.corpus_add(tx, tl[:, None].expand(512, 128).contiguous())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tcorpus.corpus_fn("broadcast_lse")(tx, tl).numpy(), want)


def test_corpus_scale_equals_the_pallas_kernel_at_its_own_shape(monkeypatch):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 4096, 4096)
    fn = _jax_corpus_fn(monkeypatch, "vmem_overflow")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fn(x))
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(ck.corpus_scale(tx, 4096).numpy(), want)
    np.testing.assert_array_equal(ck.corpus_scale(tx, 12).numpy(), want)


@pytest.mark.parametrize("shape", [(3, 5, 7), (1, 1, 1), (2, 13, 128)])
def test_corpus_scale_plain_version_is_twice_x(shape):
    x = torch.from_numpy(_normal(np.random.default_rng(2), *shape))
    for tile in (1, 4, 64):
        assert torch.equal(ck.corpus_scale(x, tile), x * 2)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ck.corpus_add(x, torch.zeros(4, 1))
    with pytest.raises(TypeError, match="float32"):
        ck.corpus_add(x.double(), x.double())
    with pytest.raises(ValueError, match="n_blocks, rows, cols"):
        ck.corpus_scale(x, 2)
    with pytest.raises(ValueError, match="tile_rows"):
        ck.corpus_scale(x[None], 0)


def test_ops_are_registered_in_the_port_namespace():
    assert torch.ops.paddle_tpu_torch.corpus_add.default._schema.name == (
        "paddle_tpu_torch::corpus_add")
    schema = str(torch.ops.paddle_tpu_torch.corpus_scale.default._schema)
    assert "Int tile_rows" in schema  # int, or SymInt where torch makes it one


def test_launch_error_carries_the_cuda_error_code():
    with pytest.raises(_build.KernelLaunchError) as e:
        _build.check(1, "corpus_scale")
    assert e.value.code == 1 and "cudaError_t 1" in str(e.value)
    _build.check(0, "corpus_scale")
    assert "corpus" in _build.SOURCES


# ---------------------------------------------------------------------------
# verdicts against the JAX linter


@pytest.mark.parametrize("name", sorted(tcorpus.CORPUS))
def test_corpus_program_trips_its_detector(name):
    findings = analysis.run_detectors(tcorpus.build_corpus_program(name))
    assert [f.detector for f in findings] == [tcorpus.CORPUS[name][1]]
    assert findings[0].severity == "error"


@pytest.mark.parametrize("name", ["broadcast_lse", "vmem_overflow"])
def test_verdicts_match_the_jax_linter(name):
    _skip_if_no_topology()
    jf = janalysis.run_detectors(jcorpus.build_corpus_program(name))
    tf = analysis.run_detectors(tcorpus.build_corpus_program(name))
    assert {f.detector for f in jf} == {jcorpus.CORPUS[name][1]}
    assert [f.detector for f in tf] == [PORT_DETECTOR[jf[0].detector]]
    assert tcorpus.CORPUS[name][1] == PORT_DETECTOR[jcorpus.CORPUS[name][1]]
    j, t = jf[0], tf[0]
    assert j.severity == t.severity == "error"
    if name == "broadcast_lse":
        assert j.bytes == t.bytes == 512 * 128 * 4
    else:
        # each against its own budget: in + out blocks double-buffered
        # against a v5e core's VMEM; one [4096, 4096] tile a block against
        # an H100 block's shared memory
        assert (j.vmem_bytes, t.smem_bytes) == (268435456, 67108864)
        assert t.budget == analysis.H100_SMEM_PER_BLOCK_OPTIN == 232448
        assert j.vmem_bytes > j.budget and t.smem_bytes > t.budget


def test_shared_memory_pricing_is_the_wrappers_sizing():
    art = tcorpus.build_corpus_program("vmem_overflow")
    (node,) = akernels.iter_kernel_calls(art.graph)
    cost = analysis.kernel_cost(node)
    assert cost.name == "corpus_scale" and cost.grid == (2, 1)
    assert analysis.kernel_smem_bytes(node) == ck.corpus_scale_smem_bytes(
        (2, 4096, 4096), torch.float32, 4096) == 67108864
    assert [ck.corpus_scale_smem_bytes((2, 4096, 4096), torch.float32, t)
            for t in (8, 12, 14, 15)] == [131072, 196608, 229376, 245760]
    (add,) = akernels.iter_kernel_calls(
        tcorpus.build_corpus_program("broadcast_lse").graph)
    assert analysis.kernel_cost(add).smem_bytes == 0
    assert analysis.kernel_cost(add).grid == (64,)  # 16384 float4s / 256


# ---------------------------------------------------------------------------
# controls


@pytest.mark.parametrize("control", ["full_b", "broadcast_32k", "tile_8"])
def test_controls_are_clean(control):
    art = {
        "full_b": lambda: analysis.capture_fn(
            ck.corpus_add, Spec((512, 128)), Spec((512, 128))),
        "broadcast_32k": lambda: analysis.capture_fn(
            lambda x, v: ck.corpus_add(
                x, v[:, None].expand(64, 128).contiguous()),
            Spec((64, 128)), Spec((64,))),
        "tile_8": lambda: _scale_program(8),
    }[control]()
    assert analysis.run_detectors(art) == []


@pytest.mark.parametrize("tile_rows, flagged", [(14, False), (15, True)])
def test_shared_memory_boundary(tile_rows, flagged):
    findings = analysis.run_detectors(_scale_program(tile_rows))
    assert bool(findings) == flagged
    if flagged:
        (f,) = findings
        assert (f.detector, f.smem_bytes, f.budget) == (
            "shared-memory-overflow", 245760, 232448)


@pytest.mark.parametrize("through", ["bare", "clone", "view", "reshape",
                                     "broadcast_to", "expand_as"])
def test_broadcast_operand_seen_through_copies_and_views(through):
    def fn(x, lse):
        col = lse[:, None]
        b = {"broadcast_to": lambda: torch.broadcast_to(col, (512, 128)),
             "expand_as": lambda: col.expand_as(x)}.get(
                 through, lambda: col.expand(512, 128))()
        if through == "clone":
            b = b.clone()
        elif through == "view":
            b = b.contiguous().view(-1).view(512, 128)
        elif through == "reshape":
            b = b.reshape(-1).flatten().unflatten(0, (512, 128))
        return ck.corpus_add(x, b)

    art = analysis.capture_fn(fn, Spec((512, 128)), Spec((512,)))
    (f,) = analysis.run_detectors(art)
    assert (f.detector, f.severity, f.bytes) == (
        "broadcast-operand", "error", 262144)


def test_raised_budget_clears_the_overflow():
    art = tcorpus.build_corpus_program("vmem_overflow")
    assert akernels.detect_shared_memory_overflow(art)
    assert akernels.detect_shared_memory_overflow(art, budget=1 << 30) == []


def test_an_unpriced_kernel_is_reported_not_priced_zero(monkeypatch):
    monkeypatch.delitem(akernels.PRICING, "corpus_add")
    art = tcorpus.build_corpus_program("broadcast_lse")
    (node,) = akernels.iter_kernel_calls(art.graph)
    with pytest.raises(akernels.UnpricedKernelError):
        analysis.kernel_smem_bytes(node)
    findings = akernels.detect_shared_memory_overflow(art)
    assert [(f.detector, f.severity) for f in findings] == [
        ("shared-memory-overflow", "info")]
    assert "corpus_add" in findings[0].message


# ---------------------------------------------------------------------------
# findings


def test_finding_severity_validated_and_json_stable():
    f = analysis.Finding(detector="shared-memory-overflow", severity="error",
                         program="p", message="m", bytes=3, where="w",
                         fingerprint="abc")
    assert f.as_dict() == {"detector": "shared-memory-overflow",
                           "severity": "error", "program": "p",
                           "message": "m", "bytes": 3, "where": "w",
                           "fingerprint": "abc"}
    g = analysis.Finding(detector="d", severity="info", program="p",
                         message="m", smem_bytes=245760, budget=232448)
    assert g.as_dict()["smem_bytes"] == 245760
    assert g.as_dict()["budget"] == 232448
    assert "smem 240.00 KB / budget 227.00 KB" in g.format()
    assert "ERROR" in f.format() and "shared-memory-overflow" in f.format()
    with pytest.raises(ValueError):
        analysis.Finding(detector="x", severity="fatal", program="p",
                         message="m")


def test_sort_findings_strongest_then_costliest():
    F = analysis.Finding
    fs = [F("a", "info", "p", "m", bytes=10 ** 9),
          F("b", "error", "p", "m", bytes=10),
          F("c", "error", "p", "m", smem_bytes=1000),
          F("d", "warning", "p", "m")]
    assert [f.detector for f in analysis.sort_findings(fs)] == [
        "c", "b", "d", "a"]


# ---------------------------------------------------------------------------
# capture


def test_capture_runs_no_kernel_and_allocates_nothing(monkeypatch):
    calls = []
    real = ck._on_cuda
    monkeypatch.setattr(ck, "_on_cuda",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    ck.reset_launches()
    art = analysis.capture_fn(lambda x: ck.corpus_scale(x, 4096),
                              Spec((2, 4096, 4096)), name="scale")
    art2 = analysis.capture_fn(
        lambda x, b: ck.corpus_add(x, b), torch.zeros(8, 4),
        torch.zeros(8, 4), name="add")
    assert calls == []
    assert (ck.corpus_add.launches, ck.corpus_scale.launches) == (0, 0)
    for a in (art, art2):
        vals = [n.meta["val"] for n in a.graph.nodes if n.op == "placeholder"]
        assert vals and all(v.device.type == "meta" for v in vals)
    targets = [str(n.target) for n in art.graph.nodes
               if n.op == "call_function"]
    assert targets == ["paddle_tpu_torch.corpus_scale.default"]


def test_capture_rejects_what_is_not_a_shape():
    with pytest.raises(TypeError, match="TensorSpec"):
        analysis.capture_fn(lambda x: x, 3)


def test_fingerprints_stable_and_distinct():
    a1 = tcorpus._capture("broadcast_lse")
    a2 = tcorpus._capture("broadcast_lse")
    b = tcorpus._capture("vmem_overflow")
    assert a1.fingerprint == a2.fingerprint
    assert a1.fingerprint != b.fingerprint
    assert len(a1.fingerprint) == 12
    assert int(a1.fingerprint, 16) >= 0


def test_captured_graph_runs_the_program():
    art = tcorpus.build_corpus_program("broadcast_lse")
    x, lse = tcorpus.corpus_inputs("broadcast_lse", seed=3, device="cpu")
    assert torch.equal(art.exported.module()(x, lse), x + lse[:, None])


# ---------------------------------------------------------------------------
# entry point and imports


def test_run_corpus_program_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(NoCudaDeviceError):
        tcorpus.run_corpus_program("broadcast_lse")
    x, lse = tcorpus.corpus_inputs("broadcast_lse", seed=5, device="cpu")
    got = tcorpus.run_corpus_program("broadcast_lse", seed=5, device="cpu")
    assert torch.equal(got, x + lse[:, None])
    want = np.random.default_rng(5).standard_normal((512, 128),
                                                     dtype=np.float32)
    np.testing.assert_array_equal(x.numpy(), want)


def test_importing_the_analysis_tier_loads_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch.analysis, "
            "paddle_tpu_torch.analysis.corpus, "
            "paddle_tpu_torch.kernels.corpus; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_port_package_does_not_import_the_analysis_tier():
    code = ("import sys, paddle_tpu_torch; "
            "sys.exit('paddle_tpu_torch.analysis' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
