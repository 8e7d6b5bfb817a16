#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no final result line):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``paddle_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) with its seconds and ptxas report.
2. Kernel parity, fp32 with TF32 off: ``flash_fwd`` against
   ``reference_attention`` and ``paged_decode`` against
   ``paged_decode_reference`` at the serving path's shapes (max abs error
   <= 1e-4); then flash_fwd's lse output, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` against ``flash_attention_fwd_reference`` /
   ``flash_attention_bwd_reference`` at the training shape and the edges
   (head_dim 64 and 128, causal and not, ragged lengths with a 0 row, S
   off the tile, Sk > Sq), max abs error <= 1e-4 * max(1, max |plain|).
   The paged kernel's verify and int8 variants against
   ``paged_verify_reference`` / ``paged_decode_reference`` on pages and
   scales the pool's own ``write_kv`` produced: verify at the serving
   shape (B 8, H 8, D 64, page 16, Sq 5, ragged q_lengths 1-5, a length
   equal to its q_length, blocks across a 64-slot chunk and a page),
   at G x Sq x D = 1280 and 5120 (row tiles), decode and verify over int8
   pages; and a verify block against single-token decode launches cut at
   each row, all within 1e-4 * max(1, max |plain|) on the valid rows.
   The long-context walks (kernel rows 4d, explicit page starts with the
   window + sink mask, and 4e, two-level tables) against
   ``paged_windowed_reference`` on pool-written pages at B 8, page 16,
   lengths up to 4096: H 8 / D 64 and H_q 8 over H_kv 2 / D 128, fp32 and
   int8, Sq 1 and 5, unevicted tables with windows, tables compacted by
   ``evict_interior``, two-level views with bs 1 and 16, windowed rows
   mixed with PAD_START rows, one window of 1, within the same bound; the
   starts walk without windows against the flat launch and the two-level
   walk against the flat starts walk are reported (expected exactly
   equal).
   The bf16 entries of flash_fwd, flash_bwd_dq and flash_bwd_dkv against
   their bf16 plain versions on the training shape and the same edges:
   each output within 2^-7 * max |plain| with at most 1% of its elements
   not bit-equal, lse within 1e-5 relative; a planted fault (P, or dS,
   dS^T and P^T, left unrounded before their products) must fail that
   gate; and the bf16 kernels against the fp32 kernels on the same values
   (out within 2^-8 * (P|V| + |out|) elementwise, gradients within 2^-6
   in norm).
   The bf16 entries of conv_stats and bn_epilogue against their bf16
   plain versions on every ResNet-50 conv shape class at batch 4 and 256
   and one case off the tiles: out and y within 2^-7 * max |plain| with
   at most 1% of the elements not bit-equal, the channel sums within
   1e-4 of the vector's largest; two planted faults against that gate
   (the batch statistics taken from the rounded conv output, which must
   fail wherever M = N * Ho * Wo <= 4096 and is reported everywhere; the
   residual left unrounded, which must fail everywhere); and the bf16
   kernels against the fp32 kernels on the same values (out within half
   a bf16 ulp, y within 2^-8 (|y| + |inv gamma out|) elementwise).
3. Serving at the Transformer-base width (vocab 10000, d_model 512,
   8 heads, 6 layers, d_inner 2048, max_length 256; random weights from a
   seed): ``ContinuousBatchingLoop.run`` on 16 requests (prompts of 16-128
   tokens, 32 new tokens each, max_batch 8, page_size 16).  The launch
   counters, zeroed just before the run, must equal prefill_steps x
   n_layer (flash) and decode_steps x n_layer (paged); the pool must end
   empty with its invariants ok.  The same requests then run through the
   plain versions on the card, and two of them through the full_decode
   oracle: tokens must match, except after a step where the plain run's
   top-2 logit margin is under the tolerance (reported).  One more run
   under ``torch.profiler`` gives the device busy time by kernel and the
   busy share of the counted run's wall time.
   Then speculative serving at the same width, on motif-tiled prompts
   (``tools/serve_bench.py --speculate``'s traffic): a d = 0 run, the
   counted ``speculate=4`` run (verify_f32 launches = spec_steps x
   n_layer, decode_f32 = (decode_steps - spec_steps) x n_layer, both
   > 0, drafts > 0, the pool clean), whose tokens must match the plain
   versions' run, the d = 0 run and (two requests) full_decode by the
   near-tie rule; a run whose drafter proposes the d = 0 run's tokens
   with every third proposal spoiled (accepted and rolled-back tokens
   both > 0, tokens as d = 0); and the int8 pool with ``speculate=4``
   (decode_i8 and verify_i8 launches = steps x n_layer, both > 0, tokens
   as its plain run; the logit distance to the fp32 run reported).  One
   more speculative run under ``torch.profiler``.
   Then long-context serving at the same width with max_length 4096: 8
   requests of 4064-token prompts, 32 new tokens each, page 16, in four
   counted arms: no window (flat tables); window 512 + 16 sink tokens
   (flat tables with explicit starts); the same through two-level tables
   of 16-page blocks; and that on an int8 pool with speculate=4 over
   motif-tiled prompts.  Launches by table walk must be decode_steps x
   n_layer on the arm's walk and 0 on the others; a windowed arm must
   evict and walk at most 35 pages (sinks + window + 2) where the
   unwindowed arm walks 256; pools end clean; windowed tokens must match
   the same arm through the plain versions and (two requests)
   full_decode under the same window by the near-tie rule, and the flat
   and two-level arms each other exactly.  Decode-step wall and device
   time (torch.profiler) of the first three arms side by side.
4. Training through the fluid entry points: ``TransformerConfig()`` with
   flash attention on and dropout off, ``MomentumOptimizer(1e-4,
   0.9).minimize``, ``Executor().run(startup)``, then ten
   ``Executor.run(main)`` steps on one fixed 32 x 256 batch.  The flash
   counters, zeroed just before the steps, must read 18 per step for
   each of flash_fwd, flash_bwd_dq and flash_bwd_dkv; every loss must be
   finite and the last below the first; the peak of allocated device
   memory over the steps is reported.  One more step under
   ``torch.profiler`` gives the device busy share and time by kernel.
   Then the startup state runs one batch-2 step on the card and on a
   ``CPUPlace`` executor (plain versions): the loss must agree within
   1e-4 relative; every param@GRAD's max abs error within 2e-3 *
   max(1, max |grad|), and its norm of error within 1e-2 of its own
   norm (floored at 1e-4 of the largest leaf's, for the key biases,
   whose exact gradient is 0).
   Then bench.py's Transformer (vocab 32000, fuse_qkv, dropout 0.1,
   batch 32 x 256, ``MomentumOptimizer(1e-4, 0.9)``) at full width, ten
   steps from one startup state under each AMP tier:
   ``fluid.enable_amp("bfloat16")`` (the fp32 flash kernels) and
   ``enable_amp("bfloat16", keep_output=True)`` (the bf16 entries).  The
   counters, zeroed before each tier, must read 18 launches per step of
   each flash kernel in the tier's dtype and 0 in the other; losses
   finite, and the dropout-free loss of the trained state below the
   startup state's; the fused_attention inputs and layer_norm outputs
   bf16 under keep, fp32 under amp1; median step, tokens/s, peak memory
   and a profiled step per tier.  Then, per tier, one batch-2 step with
   dropout 0 on the card and on the CPU: loss within 2^-6, gradients
   within 0.1 in norm (median leaf and all leaves); under keep every
   flash call of the card's step against the bf16 plain versions on the
   CPU (2^-7 max, 5% mismatch share, lse 1e-5), and a planted moved
   rounding point that must fail.  Dropout on the card: keep fraction
   within 5 sigma of 0.9, gradient g * mask, masks by seed.
5. ResNet-50 training through the fluid entry points, conv tier:
   ``resnet_imagenet(depth=50, fuse_bn="conv")`` at full width (224 x
   224, 1000 classes), ``MomentumOptimizer(0.1, 0.9).minimize``,
   ``Executor().run(startup)``, then ten steps on one fixed batch of 256
   from ``class_batch`` (seed 0).  Before it, conv-epilogue parity at
   batch 4 and at the steps' batch of 256: ``conv_stats`` and
   ``bn_epilogue`` against their plain versions on every conv shape class
   the program has (and one off the tiles: C, F and M not multiples of
   64), conv output and y within 1e-4 * max(1, max |plain|), the channel
   sums within 1e-4 of the vector's largest.  The counters, zeroed just
   before the steps, must read 53 per step for each kernel, and
   conv_stats's count by shape the program's; losses finite and the last
   below the first;
   the layout copies the wrappers made per step are reported, and the
   peak allocated memory.  One more step under ``torch.profiler``.  Then
   one batch-2 step from the startup state on the card, on a ``CPUPlace``
   executor, and on the CPU through the same program in float64 (the
   image fed as float64): the loss and every op's MeanOut / VarianceOut
   within 1e-4 of the CPU's (relative; the statistics to each vector's
   largest entry).  The gradients are ill-conditioned in fp32 at this
   depth — the CPU's own fp32 run lies 20 times phase 4's max-abs bound and
   3% in norm from float64 — so the card's gradients must lie no farther
   from the float64 ones than 3 times the CPU's fp32 gradients do, over
   all leaves and for the worst leaf; phase 4's two gates are reported,
   and each run's distance from float64 by stage and by op from the loss
   end.  The card then runs the step again with a planted forward fault,
   bn_epilogue's inv scaled by 1.01 (and by 1.001, reported only): the
   gradient gate must fail it.
   Then ResNet-50 under bf16 AMP at the same width, batch and optimizer,
   ten steps on one batch per run: the conv tier under
   ``enable_amp("bfloat16")`` and ``keep_output=True``, the unfused form
   (``fuse_bn=False``, bench.py's default: cuDNN convs, the batch_norm
   rule) under both, and ``fuse_bn=True`` under the first.  The counters,
   zeroed before each run, must read 53 launches a step of the bf16
   conv_stats and bn_epilogue entries and none of the fp32 ones in the
   conv tier, none at all in the other forms; losses finite and the last
   below the first; Y of every conv and batch-norm op bf16 under keep and
   fp32 under amp1 (one batch-2 step), every persistable fp32; median
   step, images/s, peak memory and a profiled step (device time by kind,
   copies and casts) per run.  Then the conv tier under keep, one batch-2
   step on the card and on the CPU: every conv_bn_add_act call of the
   card's step against the bf16 plain versions on its own inputs (y
   within 2^-7 * max |plain|, at most 1% of it not bit-equal, mean and
   var within 1e-4), and the card's step again with the statistics taken
   from the rounded conv output, which that gate must fail; the loss
   within 2^-5 of the CPU's and the gradients within 1.5 times the
   distance of a CPU run on the image scaled by 1 + 2^-20 (in bf16 the
   step is chaotic: that perturbation alone moves the gradients by about
   120% in norm).
6. Times from CUDA events (median of 30 after warm-up, the launches queued
   behind a device sleep so host overhead stays out): each kernel, its
   plain version, its bound (bytes over 3.35 TB/s or fp32 flops over
   67 TFLOP/s, the larger) and one PyTorch library call for the same
   function (SDPA, forward or backward; cuDNN's conv2d plus var_mean; the
   batch_norm + add + relu chain); the verify and int8 variants of the
   paged kernel at the speculative serving shape (SDPA over the gathered,
   dequantized K/V); the backward kernels and flash_fwd with lse at the
   training shape; conv_stats at the shapes of kernel rows 5 and 6,
   bn_epilogue at row 7's; rows 4d and 4e at the long-context decode
   shape after eviction (B 8, H 8, D 64, 34 live pages of a 4080-token
   context; SDPA with a boolean mask over the gathered K/V) and row 4a
   over the same context unevicted; the bf16 entries of rows 1-3 at the
   training shape (bound over the dense bf16 tensor peak, 989 TFLOP/s;
   SDPA in bf16); the bf16 entries of conv_stats (row 6: in JAX every bf16
   conv takes it) at rows 5 and 6's shapes and bn_epilogue at row 7's,
   bytes at 2-byte activations, flops over the bf16 peak, the library
   calls in bf16 on channels-last tensors.

Each phase prints one JSON line; the line before the last is the
``kernels`` summary and the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

PARITY_TOL = 1e-4      # fp32 kernel vs plain version, max abs error
# bf16 kernel vs its bf16 plain version: both round at the TPU kernel's
# points, so an output differs only where fp32 summation order moves a
# value across a bf16 rounding boundary, by one bf16 ulp (<= 2^-7 of the
# value), and only rarely; a moved rounding point changes 12-42% of them
BF16_ULP = 2.0 ** -7   # max abs err <= BF16_ULP * max |plain|
MISMATCH_SHARE = 0.01  # at most this share of the elements not bit-equal
LSE_RTOL = 1e-5        # bf16 kernels' lse vs plain, relative
BF16_VS_FP32 = 2.0 ** -6  # bf16 vs fp32 kernel gradients, relative in norm
MARGIN_TOL = 1e-3      # top-2 logit margin below which a greedy tie may flip
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
SEED = 0
CFG = dict(vocab_size=10000, d_model=512, n_head=8, n_layer=6, d_inner=2048,
           max_length=256)
MAX_BATCH, PAGE_SIZE, N_REQUESTS, MAX_NEW = 8, 16, 16, 32
PROMPT_RANGE = (16, 128)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 1 --------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit({"phase": "build", "seconds": seconds,
          "per_source_s": {n: r["seconds"] for n, r in report.items()},
          "ptxas": ptxas})


# -- phase 2 --------------------------------------------------------------

def _paged_case(torch, rng, B, Hq, Hkv, D, page_size, lengths, dev):
    """Random pool layer + zero-padded tables of distinct pages."""
    n_pages = [-(-n // page_size) for n in lengths]
    P = sum(n_pages) + 8
    k_pages = torch.randn(Hkv, P, page_size, D, generator=rng, device=dev)
    v_pages = torch.randn(Hkv, P, page_size, D, generator=rng, device=dev)
    perm = torch.randperm(P - 1, generator=rng, device=dev) + 1
    tables = torch.zeros(B, max(max(n_pages), 1), dtype=torch.int32,
                         device=dev)
    at = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = perm[at:at + n].to(torch.int32)
        at += n
    q = torch.randn(B, Hq, 1, D, generator=rng, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k_pages, v_pages, tables, lens


def phase_parity(torch):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"flash_fwd": [], "paged_decode": []}
    cases = []
    # flash: main-path shape (B=8, H=8, S=128, D=64, causal, ragged), then
    # the edges: a 0-length row with S off the 64-row tile, D=128, Sk > Sq
    flash_cases = [
        ("main", 8, 8, 128, 128, 64, True,
         [128, 100, 77, 64, 33, 16, 120, 90]),
        ("zero_len_ragged_tile", 3, 8, 100, 100, 64, True, [100, 0, 37]),
        ("noncausal_d128", 2, 4, 70, 70, 128, False, [70, 9]),
        ("cached_keys", 2, 8, 20, 150, 64, True, [150, 61]),
    ]
    for name, B, H, Sq, Sk, D, causal, lens in flash_cases:
        q = torch.randn(B, H, Sq, D, generator=rng, device=dev)
        k = torch.randn(B, H, Sk, D, generator=rng, device=dev)
        v = torch.randn(B, H, Sk, D, generator=rng, device=dev)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = fa.flash_attention(q, k, v, causal=causal, k_lengths=kl)
        want = fa.reference_attention(q, k, v, causal, D ** -0.5,
                                      k_lengths=kl)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["flash_fwd"].append(err)
        cases.append({"kernel": "flash_fwd", "case": name, "max_abs_err": err})
        if 0 in lens and not bool((got[lens.index(0)] == 0).all()):
            raise AssertionError("flash_fwd: a fully masked row is not zero")
    # paged: main-path shape (B=8, H=8, D=64, page 16), GQA G=2, and a
    # 0-length row with an odd page size
    paged_cases = [
        ("main_g1", 8, 8, 8, 64, 16, [144, 17, 60, 33, 128, 99, 40, 150]),
        ("gqa_g2", 8, 8, 4, 64, 16, [144, 17, 60, 33, 128, 99, 40, 150]),
        ("gqa_g4_d128_zero_len", 3, 8, 2, 128, 5, [23, 0, 64]),
    ]
    for name, B, Hq, Hkv, D, ps, lens in paged_cases:
        q, kp, vp, tables, ln = _paged_case(torch, rng, B, Hq, Hkv, D, ps,
                                            lens, dev)
        got = pa.paged_decode_attention(q, kp, vp, tables, ln)
        want = pa.paged_decode_reference(q, kp, vp, tables, ln)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        errs["paged_decode"].append(err)
        cases.append({"kernel": "paged_decode", "case": name,
                      "max_abs_err": err})
    emit({"phase": "parity", "tolerance": PARITY_TOL, "cases": cases})
    bad = [c for c in cases if not c["max_abs_err"] <= PARITY_TOL]
    if bad:
        raise AssertionError(f"kernel parity beyond {PARITY_TOL}: {bad}")
    return {k: max(v) for k, v in errs.items()}


# (name, B, H, Sq, Sk, D, causal, k_lengths): the training shape first (the
# decoder's causal self-attention and the non-causal encoder/cross
# attention, ragged lengths as synthetic_batch draws them), then the edges
TRAIN_LENS = [256, 128, 200, 255, 131, 177, 256, 140] * 4
BWD_CASES = [
    ("train_causal", 32, 8, 256, 256, 64, True, TRAIN_LENS),
    ("train_noncausal", 32, 8, 256, 256, 64, False, TRAIN_LENS),
    ("zero_len_ragged_tile", 3, 8, 100, 100, 64, True, [100, 0, 37]),
    ("noncausal_d128_ragged_tile", 2, 4, 70, 70, 128, False, [70, 9]),
    ("causal_d128_zero_len", 2, 4, 130, 130, 128, True, [0, 77]),
    ("cached_keys", 2, 8, 20, 150, 64, True, [150, 61]),
]


def phase_bwd_parity(torch):
    """flash_fwd's lse output and the two backward kernels against their
    plain versions.  The bound is relative to the plain values' scale:
    max abs error <= PARITY_TOL * max(1, max |plain|).  A fully masked row
    must give lse = +1e30 exactly, and dQ = 0."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases, errs = [], {"flash_fwd": [], "flash_bwd_dq": [],
                       "flash_bwd_dkv": []}

    def record(kernel, name, got, want):
        err = float((got - want).abs().max())
        bound = PARITY_TOL * max(1.0, float(want.abs().max()))
        cases.append({"kernel": kernel, "case": name, "max_abs_err": err,
                      "bound": bound})
        errs[kernel].append(err)

    for name, B, H, Sq, Sk, D, causal, lens in BWD_CASES:
        q = torch.randn(B, H, Sq, D, generator=rng, device=dev)
        k = torch.randn(B, H, Sk, D, generator=rng, device=dev)
        v = torch.randn(B, H, Sk, D, generator=rng, device=dev)
        dout = torch.randn(B, H, Sq, D, generator=rng, device=dev)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, kl)
        want_out, want_lse = fa.flash_attention_fwd_reference(
            q, k, v, causal, scale, kl)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, kl, out, lse, dout,
                                            causal, scale)
        want = fa.flash_attention_bwd_reference(q, k, v, kl, want_out,
                                                want_lse, dout, causal, scale)
        torch.cuda.synchronize()
        live = want_lse < 1e29
        if not bool((lse[~live] == -fa.NEG_INF).all()):
            raise AssertionError(f"{name}: a fully masked row's lse is not "
                                 "+1e30")
        if 0 in lens and not bool((dq[lens.index(0)] == 0).all()):
            raise AssertionError(f"{name}: a fully masked row's dQ is not 0")
        record("flash_fwd", name + "/out", out, want_out)
        record("flash_fwd", name + "/lse", lse[live], want_lse[live])
        record("flash_bwd_dq", name, dq, want[0])
        record("flash_bwd_dkv", name + "/dk", dk, want[1])
        record("flash_bwd_dkv", name + "/dv", dv, want[2])
    emit({"phase": "bwd_parity", "tolerance": "max abs err <= "
          f"{PARITY_TOL} * max(1, max |plain|)", "cases": cases})
    bad = [c for c in cases if not c["max_abs_err"] <= c["bound"]]
    if bad:
        raise AssertionError(f"backward parity beyond its bound: {bad}")
    return {k: max(v) for k, v in errs.items()}


def _bf16_gate(got, want):
    """A bf16 kernel output against its plain version: max abs error, its
    bound (BF16_ULP * max |plain|) and the share of elements not
    bit-equal."""
    err = float((got.float() - want.float()).abs().max())
    bound = BF16_ULP * float(want.float().abs().max())
    share = float((got != want).float().mean())
    return {"max_abs_err": err, "bound": bound, "mismatch_share": share,
            "ok": err <= bound and share <= MISMATCH_SHARE}


def _moved_bwd(fa, q, k, v, k_lengths, out, lse, dout, causal, scale):
    """The bf16 backward with its operand rounding points moved past the
    products: dS, dS^T and P^T enter them in fp32 (the gradients still
    round once at the end)."""
    f = [t.float() for t in (q, k, v, out, dout)]
    return tuple(g.to(q.dtype) for g in fa.flash_attention_bwd_reference(
        f[0], f[1], f[2], k_lengths, f[3], lse, f[4], causal, scale))


def phase_bf16_parity(torch):
    """The bf16 entries of flash_fwd, flash_bwd_dq and flash_bwd_dkv
    against their bf16 plain versions (forward: 64-key tiles, as the
    kernel), on BWD_CASES in bf16, the backward on the kernel's own out
    and lse.  Each output: max abs error <= BF16_ULP * max |plain| and at
    most MISMATCH_SHARE of its elements not bit-equal; lse within
    LSE_RTOL.  A planted fault — P unrounded before PV in the forward,
    dS / dS^T / P^T unrounded in the backward — must fail that gate.
    Then the bf16 kernels against the fp32 kernels on the same
    (bf16-valued) inputs: out within 2^-8 * (sum_j P_ij |V_j| + |out|)
    elementwise (the rounding of P and of the output, at most half a
    bf16 ulp each, plus 1e-5 of the first term for fp32 order), lse
    within LSE_RTOL, and each gradient within BF16_VS_FP32 of the fp32
    one in norm (two roundings of at most 2^-8 each, with margin)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    cases, faults, vs_fp32 = [], [], []
    errs = {"flash_fwd": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    for name, B, H, Sq, Sk, D, causal, lens in BWD_CASES:
        q, k, v, dout = (torch.randn(B, H, S, D, generator=rng,
                                     device=dev).to(bf16)
                         for S in (Sq, Sk, Sk, Sq))
        f = [t.float() for t in (q, k, v, dout)]
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale, kl)
        want_out, want_lse = fa.flash_attention_fwd_bf16_reference(
            q, k, v, causal, scale, kl)
        grads = fa.flash_attention_bwd(q, k, v, kl, out, lse, dout, causal,
                                       scale)
        want = fa.flash_attention_bwd_reference(q, k, v, kl, out, lse, dout,
                                                causal, scale)
        moved_out = fa.flash_attention_fwd_reference(
            f[0], f[1], f[2], causal, scale, kl)[0].to(bf16)
        moved = _moved_bwd(fa, q, k, v, kl, out, lse, dout, causal, scale)
        out32, lse32 = fa.flash_attention_fwd(f[0], f[1], f[2], causal,
                                              scale, kl)
        grads32 = fa.flash_attention_bwd(f[0], f[1], f[2], kl, out32, lse32,
                                         f[3], causal, scale)
        pv = fa.reference_attention(f[0], f[1], f[2].abs(), causal, scale,
                                    k_lengths=kl)
        torch.cuda.synchronize()
        live = want_lse < 1e29
        if not bool((lse[~live] == -fa.NEG_INF).all()):
            raise AssertionError(f"{name}: a fully masked row's bf16 lse is "
                                 "not +1e30")
        if 0 in lens and not (bool((out[lens.index(0)] == 0).all())
                              and bool((grads[0][lens.index(0)] == 0).all())):
            raise AssertionError(f"{name}: a fully masked row's bf16 out or "
                                 "dQ is not 0")
        lse_rel = float(((lse - want_lse).abs()
                         / want_lse.abs().clamp_min(1e-30))[live].max())
        rows = [("flash_fwd", "out", out, want_out, moved_out)] + [
            (kernel, what, g, w, m) for kernel, what, g, w, m in zip(
                ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                ("dq", "dk", "dv"), grads, want, moved)]
        for kernel, what, got, plain, bad in rows:
            gate = _bf16_gate(got, plain)
            cases.append({"kernel": kernel + "_bf16", "case": name,
                          "what": what, **gate})
            errs[kernel].append(gate["max_abs_err"])
            planted = _bf16_gate(got, bad)
            faults.append({"kernel": kernel + "_bf16", "case": name,
                           "what": what, "mismatch_share":
                           planted["mismatch_share"], "max_abs_err":
                           planted["max_abs_err"],
                           "caught": not planted["ok"]})
        cases.append({"kernel": "flash_fwd_bf16", "case": name, "what": "lse",
                      "rel_err": lse_rel, "ok": lse_rel <= LSE_RTOL})
        out_bound = 2.0 ** -8 * (pv + out32.abs()) + 1e-5 * pv
        lse32_rel = float(((lse - lse32).abs()
                           / lse32.abs().clamp_min(1e-30))[live].max())
        grad_rel = [float((g.float() - g32).norm() / g32.norm())
                    for g, g32 in zip(grads, grads32)]
        vs_fp32.append({
            "case": name,
            "out_err_over_bound": float(((out.float() - out32).abs()
                                         / out_bound.clamp_min(1e-30)).max()),
            "lse_rel_err": lse32_rel, "grad_norm_rel_err": dict(
                zip(("dq", "dk", "dv"), grad_rel)),
            "ok": bool(((out.float() - out32).abs() <= out_bound).all())
            and lse32_rel <= LSE_RTOL
            and max(grad_rel) <= BF16_VS_FP32})
    emit({"phase": "bf16_parity", "tolerance": (
              f"max abs err <= {BF16_ULP} * max |plain| and at most "
              f"{MISMATCH_SHARE} of the elements not bit-equal; lse "
              f"rel err <= {LSE_RTOL}"),
          "cases": cases, "planted_rounding_faults": faults,
          "vs_fp32_kernels": vs_fp32,
          "vs_fp32_tolerance": (
              "out: |bf16 - fp32| <= 2^-8 * (P|V| + |out|) + 1e-5 * P|V| "
              f"elementwise; lse rel <= {LSE_RTOL}; grads: |bf16 - fp32| "
              f"<= {BF16_VS_FP32} * |fp32| in norm")})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"bf16 parity beyond its bound: {bad}")
    missed = [c for c in faults if not c["caught"]]
    if missed:
        raise AssertionError(f"a planted rounding fault passed the gate: "
                             f"{missed}")
    bad = [c for c in vs_fp32 if not c["ok"]]
    if bad:
        raise AssertionError(f"bf16 kernels beyond their bound against the "
                             f"fp32 kernels: {bad}")
    return {k: max(v) for k, v in errs.items()}


# -- phase 3 --------------------------------------------------------------

def make_requests(serving, np):
    rng = np.random.RandomState(SEED)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [serving.DecodeRequest(
        prompt=rng.randint(1, CFG["vocab_size"], size=int(n)).tolist(),
        max_new_tokens=MAX_NEW) for n in lens]


def _plain_decoder_cls(serving):
    """A TransformerDecoder whose attention calls are the plain versions;
    a TwoLevelTables or a long-context keyword sends the paged calls to
    paged_windowed_reference."""
    from torch import is_tensor as torch_is_tensor

    from paddle_tpu_torch.kernels.flash_attention import reference_attention
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_reference,
        paged_verify_reference,
        paged_windowed_reference,
    )

    class PlainDecoder(serving.TransformerDecoder):
        """The serving decoder with the plain versions called by name."""

        def attend_prefill(self, q, k, v, lens):
            return reference_attention(q, k, v, True, self.cfg.head_dim ** -0.5,
                                       k_lengths=lens)

        def attend_decode(self, q, k_pages, v_pages, tables, lengths,
                          k_scales=None, v_scales=None, **walk):
            if walk or not torch_is_tensor(tables):
                return paged_windowed_reference(
                    q, k_pages, v_pages, tables, lengths, None,
                    walk.get("page_starts"), walk.get("windows"),
                    walk.get("sinks"), self.cfg.head_dim ** -0.5, k_scales,
                    v_scales)
            return paged_decode_reference(q, k_pages, v_pages, tables,
                                          lengths, self.cfg.head_dim ** -0.5,
                                          k_scales, v_scales)

        def attend_verify(self, q, k_pages, v_pages, tables, lengths,
                          q_lengths, k_scales=None, v_scales=None, **walk):
            if walk or not torch_is_tensor(tables):
                return paged_windowed_reference(
                    q, k_pages, v_pages, tables, lengths, q_lengths,
                    walk.get("page_starts"), walk.get("windows"),
                    walk.get("sinks"), self.cfg.head_dim ** -0.5, k_scales,
                    v_scales)
            return paged_verify_reference(q, k_pages, v_pages, tables,
                                          lengths, q_lengths,
                                          self.cfg.head_dim ** -0.5,
                                          k_scales, v_scales)

    return PlainDecoder


def _new_pool(serving, cfg, device=None, dtype="float32"):
    per_seq = -(-(PROMPT_RANGE[1] + MAX_NEW) // PAGE_SIZE)
    return serving.KVCachePool(
        num_pages=MAX_BATCH * per_seq + 4, page_size=PAGE_SIZE,
        num_layers=cfg.n_layer, num_heads=cfg.n_head, head_dim=cfg.head_dim,
        num_kv_heads=cfg.num_kv_heads, device=device, dtype=dtype)


def _compare_tokens(got, want):
    """Token identity up to the first divergence; a divergence is allowed
    only where the reference's top-2 margin is under MARGIN_TOL (a greedy
    near-tie).  Returns (max |logit diff| over matched steps, near-ties)."""
    import numpy as np

    max_diff, ties = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        for t, (gt, wt) in enumerate(zip(g.tokens, w.tokens)):
            max_diff = max(max_diff, float(np.abs(g.logits[t]
                                                  - w.logits[t]).max()))
            if gt == wt:
                continue
            top2 = np.sort(w.logits[t])[-2:]
            margin = float(top2[1] - top2[0])
            if margin >= MARGIN_TOL:
                raise AssertionError(
                    f"request {i} step {t}: token {gt} vs reference {wt} "
                    f"with top-2 margin {margin}")
            ties.append({"request": i, "step": t, "margin": margin})
            break
        else:
            if len(g.tokens) != len(w.tokens):
                raise AssertionError(f"request {i}: {len(g.tokens)} tokens "
                                     f"vs reference {len(w.tokens)}")
    return max_diff, ties


def phase_main_path(torch, np):
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    cfg = serving.DecodeConfig(**CFG)
    params = serving.init_decode_params(cfg, seed=SEED)
    reqs = make_requests(serving, np)
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    # warm-up run (cuBLAS handles, allocator), then the counted run
    serving.ContinuousBatchingLoop(model, cfg, _new_pool(serving, cfg),
                                   max_batch=MAX_BATCH).run(reqs)
    pool = _new_pool(serving, cfg)
    loop = serving.ContinuousBatchingLoop(model, cfg, pool,
                                          max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    fa.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    results = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_attention.launches,
                "paged_decode": pa.paged_decode_attention.launches}
    want = {"flash_fwd": loop.prefill_steps * cfg.n_layer,
            "paged_decode": loop.decode_steps * cfg.n_layer}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"launches {launches} != steps x n_layer {want}")
    report = pool.check_invariants()
    if not report["ok"] or pool.used_pages:
        raise AssertionError(f"pool not clean after the run: {report}")
    n_tokens = sum(len(r.tokens) for r in results)
    for r in results:
        if r.error is not None:
            raise AssertionError(f"sequence {r.seq_id} failed: {r.error}")
        if not all(np.isfinite(row).all() and row.shape == (cfg.vocab_size,)
                   for row in r.logits):
            raise AssertionError(f"sequence {r.seq_id}: bad logits rows")
    if n_tokens != N_REQUESTS * MAX_NEW:
        raise AssertionError(f"{n_tokens} tokens, want {N_REQUESTS * MAX_NEW}")

    # the same requests through the plain versions on the card
    plain = _plain_decoder_cls(serving)(cfg).load_jax_params(params)
    plain_loop = serving.ContinuousBatchingLoop(
        plain, cfg, _new_pool(serving, cfg), max_batch=MAX_BATCH)
    plain_results = plain_loop.run(reqs)
    plain_diff, plain_ties = _compare_tokens(results, plain_results)
    # and two of them through the full-recompute oracle
    oracle = []
    for r in reqs[:2]:
        toks, rows = serving.full_decode(params, cfg, r.prompt,
                                         r.max_new_tokens)
        oracle.append(serving.GeneratedSequence(seq_id=-1, prompt=r.prompt,
                                                tokens=toks, logits=rows))
    oracle_diff, oracle_ties = _compare_tokens(results[:2], oracle)
    trace = _trace(torch, serving, model, cfg, reqs, wall)
    emit({"phase": "main_path", "config": CFG, "max_batch": MAX_BATCH,
          "page_size": PAGE_SIZE, "requests": N_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "max_new_tokens": MAX_NEW, "prefill_steps": loop.prefill_steps,
          "decode_steps": loop.decode_steps, "launches": launches,
          "generated_tokens": n_tokens, "wall_s": wall,
          "tokens_per_s": n_tokens / wall,
          "prefill_step_ms_median": 1e3 * statistics.median(
              loop.prefill_step_s),
          "decode_step_ms_median": 1e3 * statistics.median(
              loop.decode_step_s),
          "pool": pool.stats(),
          "vs_plain": {"max_abs_logit_diff": plain_diff,
                       "near_ties": plain_ties},
          "vs_full_decode": {"requests": 2, "max_abs_logit_diff": oracle_diff,
                             "near_ties": oracle_ties},
          "trace": trace})
    return launches, reqs


def _trace(torch, serving, model, cfg, reqs, unprofiled_wall, **loop_kw):
    """One more run of the same requests under torch.profiler.  Device
    busy time is the summed time of the device's own events (kernels,
    copies, fills; one stream, so they never overlap) — the host-side
    operator events also carry device time, of the kernels they launched,
    and are left out so nothing counts twice.  The profiler's host cost
    stretches the traced run's wall, so the busy share is taken against
    the unprofiled run's wall: the same requests do the same device
    work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loop = serving.ContinuousBatchingLoop(model, cfg, _new_pool(serving, cfg),
                                          max_batch=MAX_BATCH, **loop_kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_s = sum(by_name.values()) / 1e6
    if not busy_s:
        raise AssertionError("the profiler saw no device time")
    attention_us = sum(us for k, us in by_name.items()
                       if "flash_fwd" in k or "paged_attn" in k)
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / unprofiled_wall,
            "attention_share_of_busy": attention_us / 1e6 / busy_s,
            "device_ms_by_kernel": _top_kernels(by_name, 8),
            "attention_ms": attention_us / 1e3}


# -- phase 3b: speculative serving -----------------------------------------

SPEC_D = 4             # drafted tokens per round (verify rows Sq = 5)
ORACLE_EVERY = 3       # the oracle drafter spoils every third proposal
# (name, H_q, H_kv, D, dtype): verify and int8 parity cases; B = 8, page 16,
# Sq = 5.  (length, q_length) pairs: one length equal to its q_length, one
# block crossing the 64-slot chunk (61..65), one crossing a page (14..17);
# the q_lengths cover 1..5
SPEC_LENS = [(144, 5), (3, 3), (66, 5), (18, 4), (150, 1), (99, 2),
             (40, 5), (17, 4)]
SPEC_CASES = [
    ("verify_f32_serving", 8, 8, 64, "float32"),
    ("verify_f32_gqa_GSqD_1280", 8, 2, 64, "float32"),
    ("verify_f32_gqa_GSqD_5120", 16, 2, 128, "float32"),
    ("verify_i8_serving", 8, 8, 64, "int8"),
    ("verify_i8_gqa_GSqD_5120", 16, 2, 128, "int8"),
]


def _pool_layer(torch, serving, rng, Hq, Hkv, D, lengths, dtype, dev):
    """One layer of a pool filled through the pool's own write_kv: every
    sequence's tokens in two rounds, the second at twice the magnitude
    (an int8 page's amax grows and its content re-quantizes).  Returns
    (pool, tables, lengths) on the card."""
    pages = sum(-(-n // PAGE_SIZE) for n in lengths) + 4
    pool = serving.KVCachePool(pages, PAGE_SIZE, 1, Hq, D, num_kv_heads=Hkv,
                               dtype=dtype)
    ids = list(range(len(lengths)))
    for s in ids:
        pool.allocate(s)
    first = [n // 2 for n in lengths]
    for counts, gain in ((first, 1.0),
                         ([n - f for n, f in zip(lengths, first)], 2.0)):
        pg, sl = pool.append_tokens(ids, counts)
        k = gain * torch.randn(len(pg), Hkv, D, generator=rng, device=dev)
        v = gain * torch.randn(len(pg), Hkv, D, generator=rng, device=dev)
        pool.write_kv(0, pg, sl, k, v)
    tables, lens = pool.page_table_batch(ids)
    return (pool, torch.as_tensor(tables, device=dev),
            torch.as_tensor(lens, device=dev))


def phase_spec_parity(torch):
    """The verify and int8 variants against their plain versions, on pages
    (and scales) the pool's own write_kv produced: verify at the serving
    shape and at G * Sq * D = 1280 and 5120 (row tiles), decode int8,
    verify int8; then a verify block against stacked single-token decode
    launches, row by row.  Bound: max abs error <= PARITY_TOL * max(1,
    max |plain|)."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 5)
    lengths = [n for n, _ in SPEC_LENS]
    qlens = torch.tensor([q for _, q in SPEC_LENS], dtype=torch.int32,
                         device=dev)
    cases = []
    errs = {v: [] for v in pa.VARIANTS if v != "decode_f32"}

    def record(variant, name, got, want):
        err = float((got - want).abs().max())
        bound = PARITY_TOL * max(1.0, float(want.abs().max()))
        cases.append({"kernel": "paged_" + variant, "case": name,
                      "max_abs_err": err, "bound": bound})
        if variant in errs:
            errs[variant].append(err)

    for name, Hq, Hkv, D, dtype in SPEC_CASES:
        pool, tables, ln = _pool_layer(torch, serving, rng, Hq, Hkv, D,
                                       lengths, dtype, dev)
        kp, vp = pool.k_pages[0], pool.v_pages[0]
        ks, vs = pool.layer_scales(0)
        q = torch.randn(len(lengths), Hq, SPEC_D + 1, D, generator=rng,
                        device=dev)
        got = pa.paged_decode_attention(q, kp, vp, tables, ln,
                                        q_lengths=qlens, k_scales=ks,
                                        v_scales=vs)
        want = pa.paged_verify_reference(q, kp, vp, tables, ln, qlens,
                                         D ** -0.5, ks, vs)
        torch.cuda.synchronize()
        rows = (torch.arange(SPEC_D + 1, device=dev)[None, :]
                < qlens[:, None])[:, None, :, None]  # valid rows only
        variant = "verify_i8" if dtype == "int8" else "verify_f32"
        record(variant, name, got * rows, want * rows)
        if dtype == "int8":
            q1 = q[:, :, :1].contiguous()
            record("decode_i8", name.replace("verify", "decode"),
                   pa.paged_decode_attention(q1, kp, vp, tables, ln,
                                             k_scales=ks, v_scales=vs),
                   pa.paged_decode_reference(q1, kp, vp, tables, ln,
                                             D ** -0.5, ks, vs))
        if name == "verify_f32_serving":
            # row t of each block against a decode launch whose lengths
            # end at that row's position
            stacked = torch.zeros_like(got)
            for t in range(SPEC_D + 1):
                ln_t = torch.where(t < qlens, ln - qlens + t + 1, ln)
                stacked[:, :, t:t + 1] = pa.paged_decode_attention(
                    q[:, :, t:t + 1].contiguous(), kp, vp, tables, ln_t)
            torch.cuda.synchronize()
            record("verify_f32", "verify_vs_stacked_decode",
                   got * rows, stacked * rows)
    emit({"phase": "spec_parity", "tolerance": "max abs err <= "
          f"{PARITY_TOL} * max(1, max |plain|), valid rows",
          "lengths_and_q_lengths": SPEC_LENS, "cases": cases})
    bad = [c for c in cases if not c["max_abs_err"] <= c["bound"]]
    if bad:
        raise AssertionError(f"verify / int8 parity beyond its bound: {bad}")
    return {k: max(v) for k, v in errs.items()}


def make_spec_requests(serving, np):
    """The speculative traffic as tools/serve_bench.py builds it under
    --speculate: one random motif of min(6, the shortest prompt) tokens,
    tiled to each prompt's length (drawn from PROMPT_RANGE)."""
    rng = np.random.RandomState(SEED)
    motif = rng.randint(1, CFG["vocab_size"],
                        size=max(2, min(6, PROMPT_RANGE[0]))).tolist()
    reqs = []
    for _ in range(N_REQUESTS):
        plen = int(rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1))
        reps = -(-plen // len(motif))
        reqs.append(serving.DecodeRequest(prompt=(motif * reps)[:plen],
                                          max_new_tokens=MAX_NEW))
    return reqs


class OracleDrafter:
    """Proposes a reference run's own continuation of each request (seq
    id i is request i: the loop numbers sequences in admission order, and
    admission is FIFO), with the last token of every ORACLE_EVERY-th
    proposal replaced, so that blocks are both accepted and rolled back."""

    stateful = True

    def __init__(self, reqs, results, vocab):
        self.full = [list(r.prompt) + list(res.tokens)
                     for r, res in zip(reqs, results)]
        self.vocab, self.calls = vocab, 0

    def draft(self, context, max_draft, seq_id):
        n = len(context)
        out = self.full[seq_id][n:n + max_draft]
        self.calls += 1
        if out and self.calls % ORACLE_EVERY == 0:
            out[-1] = (out[-1] + 1) % self.vocab
        return out

    def release(self, seq_id):
        pass


def _logit_distance(np, got, want):
    """max |logit difference| over the steps both runs reached with the
    same tokens."""
    dist = 0.0
    for g, w in zip(got, want):
        for t, (gt, wt) in enumerate(zip(g.tokens, w.tokens)):
            dist = max(dist, float(np.abs(g.logits[t] - w.logits[t]).max()))
            if gt != wt:
                break
    return dist


def _check_run(np, cfg, loop, pool, results, name):
    report = pool.check_invariants()
    if not report["ok"] or pool.used_pages:
        raise AssertionError(f"{name}: pool not clean after the run: "
                             f"{report}")
    for r in results:
        if r.error is not None:
            raise AssertionError(f"{name}: sequence {r.seq_id} failed: "
                                 f"{r.error}")
        if len(r.tokens) != MAX_NEW or not all(
                np.isfinite(row).all() and row.shape == (cfg.vocab_size,)
                for row in r.logits):
            raise AssertionError(f"{name}: sequence {r.seq_id}: "
                                 f"{len(r.tokens)} tokens or bad logits")


def _counted_run(torch, serving, model, cfg, reqs, dtype="float32", **kw):
    """One loop run with every launch counter zeroed just before it and
    read just after.  Returns (loop, pool, results, wall_s, launches)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    pool = _new_pool(serving, cfg, dtype=dtype)
    loop = serving.ContinuousBatchingLoop(model, cfg, pool,
                                          max_batch=MAX_BATCH, **kw)
    torch.cuda.synchronize()
    fa.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    results = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.paged_decode_attention.launches_by_variant,
                    flash_fwd=fa.flash_attention.launches)
    return loop, pool, results, wall, launches


def _gate_launches(cfg, loop, launches, decode, verify, name):
    want = {"flash_fwd": loop.prefill_steps * cfg.n_layer,
            verify: loop.spec_steps * cfg.n_layer,
            decode: (loop.decode_steps - loop.spec_steps) * cfg.n_layer}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if got != want or not all(got.values()) or others:
        raise AssertionError(f"{name}: launches {launches}, want {want} "
                             "(each > 0, no other variant)")


def _spec_summary(loop, wall, n_tokens):
    return {"steps": loop.steps, "prefill_steps": loop.prefill_steps,
            "decode_steps": loop.decode_steps, "spec_steps": loop.spec_steps,
            "drafted_tokens": loop.drafted_tokens,
            "accepted_tokens": loop.accepted_tokens,
            "rolled_back_tokens": loop.rolled_back_tokens,
            "acceptance_rate": loop.acceptance_rate(),
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "verify_step_ms_median": (1e3 * statistics.median(
                loop.verify_step_s) if loop.verify_step_s else None),
            "decode_step_ms_median": (1e3 * statistics.median(
                loop.decode_step_s) if loop.decode_step_s else None)}


def phase_spec_main_path(torch, np):
    """Speculative serving at the Transformer-base width on the motif
    traffic: the d = 0 kernel run, the counted speculate=4 run (fp32
    pool), the same loop through the plain versions on the card, two
    requests through full_decode, an oracle-drafter run, and the int8
    pool run with its plain twin."""
    from paddle_tpu_torch import serving

    cfg = serving.DecodeConfig(**CFG)
    params = serving.init_decode_params(cfg, seed=SEED)
    reqs = make_spec_requests(serving, np)
    n_tokens = N_REQUESTS * MAX_NEW
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    plain = _plain_decoder_cls(serving)(cfg).load_jax_params(params)
    # warm-up (the verify shapes' first launches), then the counted runs
    serving.ContinuousBatchingLoop(model, cfg, _new_pool(serving, cfg),
                                   max_batch=MAX_BATCH,
                                   speculate=SPEC_D).run(reqs)
    loop0, pool0, res0, wall0, _ = _counted_run(torch, serving, model, cfg,
                                                reqs)
    _check_run(np, cfg, loop0, pool0, res0, "d=0")
    loop, pool, res, wall, launches = _counted_run(
        torch, serving, model, cfg, reqs, speculate=SPEC_D)
    _gate_launches(cfg, loop, launches, "decode_f32", "verify_f32",
                   "spec_main_path")
    _check_run(np, cfg, loop, pool, res, "spec_main_path")
    if not loop.drafted_tokens:
        raise AssertionError("spec_main_path: nothing was drafted")
    plain_res = serving.ContinuousBatchingLoop(
        plain, cfg, _new_pool(serving, cfg), max_batch=MAX_BATCH,
        speculate=SPEC_D).run(reqs)
    plain_diff, plain_ties = _compare_tokens(res, plain_res)
    d0_diff, d0_ties = _compare_tokens(res, res0)
    oracle = []
    for r in reqs[:2]:
        toks, rows = serving.full_decode(params, cfg, r.prompt,
                                         r.max_new_tokens)
        oracle.append(serving.GeneratedSequence(seq_id=-1, prompt=r.prompt,
                                                tokens=toks, logits=rows))
    oracle_diff, oracle_ties = _compare_tokens(res[:2], oracle)

    # the oracle drafter: proposals from the d = 0 run, every third spoiled
    loop_o, pool_o, res_o, wall_o, launches_o = _counted_run(
        torch, serving, model, cfg, reqs, speculate=SPEC_D,
        drafter=OracleDrafter(reqs, res0, cfg.vocab_size))
    _check_run(np, cfg, loop_o, pool_o, res_o, "oracle_drafter")
    if not (loop_o.accepted_tokens and loop_o.rolled_back_tokens):
        raise AssertionError(
            f"oracle drafter: accepted {loop_o.accepted_tokens}, rolled "
            f"back {loop_o.rolled_back_tokens}: both must be > 0")
    oracle_d0_diff, oracle_d0_ties = _compare_tokens(res_o, res0)

    # the int8 pool, kernels and plain versions
    loop8, pool8, res8, wall8, launches8 = _counted_run(
        torch, serving, model, cfg, reqs, dtype="int8", speculate=SPEC_D)
    _gate_launches(cfg, loop8, launches8, "decode_i8", "verify_i8", "int8")
    _check_run(np, cfg, loop8, pool8, res8, "int8")
    plain8 = serving.ContinuousBatchingLoop(
        plain, cfg, _new_pool(serving, cfg, dtype="int8"),
        max_batch=MAX_BATCH, speculate=SPEC_D).run(reqs)
    plain8_diff, plain8_ties = _compare_tokens(res8, plain8)
    trace = _trace(torch, serving, model, cfg, reqs, wall, speculate=SPEC_D)
    emit({"phase": "spec_main_path", "config": CFG, "speculate": SPEC_D,
          "max_batch": MAX_BATCH, "page_size": PAGE_SIZE,
          "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
          "traffic": "motif-tiled (tools/serve_bench.py --speculate)",
          "prompt_lens": [len(r.prompt) for r in reqs],
          "launches": launches, "d0": _spec_summary(loop0, wall0, n_tokens),
          "spec": _spec_summary(loop, wall, n_tokens),
          "steps_vs_d0": [loop.steps, loop0.steps],
          "pool": pool.stats(),
          "vs_plain": {"max_abs_logit_diff": plain_diff,
                       "near_ties": plain_ties},
          "vs_d0": {"max_abs_logit_diff": d0_diff, "near_ties": d0_ties},
          "vs_full_decode": {"requests": 2, "max_abs_logit_diff": oracle_diff,
                             "near_ties": oracle_ties},
          "trace": trace})
    emit({"phase": "spec_oracle_drafter", "spoiled": f"every "
          f"{ORACLE_EVERY}rd proposal's last token",
          "launches": launches_o,
          "run": _spec_summary(loop_o, wall_o, n_tokens),
          "vs_d0": {"max_abs_logit_diff": oracle_d0_diff,
                    "near_ties": oracle_d0_ties}})
    emit({"phase": "spec_int8", "launches": launches8,
          "run": _spec_summary(loop8, wall8, n_tokens),
          "pool": pool8.stats(), "bytes_per_page": pool8.bytes_per_page(),
          "fp32_bytes_per_page": pool.bytes_per_page(),
          "vs_plain": {"max_abs_logit_diff": plain8_diff,
                       "near_ties": plain8_ties},
          "max_abs_logit_distance_to_fp32_run": _logit_distance(np, res8,
                                                                res)})
    return {"spec": launches, "int8": launches8}, reqs


# -- phase 3c: long-context serving ----------------------------------------

LC_MAX_LENGTH = 4096   # the decoder's position table at long context
LC_PROMPT = 4064       # tools/serve_bench.py --context-len's prompt shape
LC_WINDOW, LC_SINKS, LC_BLOCK = 512, 16, 16
# the widest walk a windowed step may take: the sink pages, the window's
# pages, one partial page at the window's edge and one the step appends
LC_TABLE_CAP = (-(-LC_SINKS // PAGE_SIZE) + -(-LC_WINDOW // PAGE_SIZE) + 2)
# parity cases: (H_q, H_kv, D, pool dtype) at B 8, page 16, Sq 1 and 5; the
# lengths run to a 4096-token context, the windows mix windowed rows (one
# with window 1) and rows without a window (PAD_START)
LC_PARITY_HEADS = [(8, 8, 64, "float32"), (8, 8, 64, "int8"),
                   (8, 2, 128, "float32"), (8, 2, 128, "int8")]
LC_PARITY_LENS = [4096, 3001, 1500, 700, 530, 100, 17, 5]
LC_PARITY_QLENS = [5, 4, 5, 1, 3, 5, 2, 5]


def _lc_windows(torch, dev):
    from paddle_tpu_torch.kernels.paged_attention import PAD_START

    win = torch.tensor([LC_WINDOW, 64, PAD_START, 1, LC_WINDOW, 40, PAD_START,
                        LC_WINDOW], dtype=torch.int32, device=dev)
    snk = torch.tensor([LC_SINKS, 0, 0, 0, 32, 16, 0, LC_SINKS],
                       dtype=torch.int32, device=dev)
    return win, snk


def _lc_pool(torch, serving, rng, Hq, Hkv, D, dtype, dev, windows=None,
             sinks=None):
    """One layer of a pool filled through write_kv at LC_PARITY_LENS (in
    two rounds, the second at twice the magnitude: an int8 page's content
    re-quantizes).  With windows, each windowed row's interior is evicted
    before its last SPEC_D + 1 tokens are appended, as the loop evicts
    before a step's appends.  Returns (pool, ids)."""
    lengths = LC_PARITY_LENS
    tail = SPEC_D + 1
    pages = sum(-(-n // PAGE_SIZE) for n in lengths) + 4
    pool = serving.KVCachePool(pages, PAGE_SIZE, 1, Hq, D, num_kv_heads=Hkv,
                               dtype=dtype)
    ids = list(range(len(lengths)))
    for s in ids:
        pool.allocate(s)

    def fill(counts, gain):
        pg, sl = pool.append_tokens(ids, counts)
        k = gain * torch.randn(len(pg), Hkv, D, generator=rng, device=dev)
        v = gain * torch.randn(len(pg), Hkv, D, generator=rng, device=dev)
        pool.write_kv(0, pg, sl, k, v)

    first = [(n - tail) // 2 for n in lengths]
    fill(first, 1.0)
    fill([n - tail - f for n, f in zip(lengths, first)], 2.0)
    if windows is not None:
        for s, w, k in zip(ids, windows.tolist(), sinks.tolist()):
            if w < LC_MAX_LENGTH:  # PAD_START rows keep every page
                pool.evict_interior(s, w, k)
    fill([tail] * len(ids), 2.0)
    return pool, ids


def _valid_rows(torch, qlens, sq, dev):
    """[B, 1, sq, 1] mask of the rows a step reads (t < q_lengths[b])."""
    if sq == 1:
        return torch.ones(len(LC_PARITY_LENS), 1, 1, 1, dtype=torch.bool,
                          device=dev)
    return (torch.arange(sq, device=dev)[None, :]
            < qlens[:, None])[:, None, :, None]


def _two_level_on(torch, pa, tl, dev):
    return pa.TwoLevelTables(*(torch.as_tensor(a, device=dev)
                               for a in (tl.l1, tl.l2, tl.starts)),
                             tl.block_size)


def phase_longctx_parity(torch):
    """Rows 4d (explicit starts, window + sink mask) and 4e (two-level
    walk) against paged_windowed_reference on pages the pool's write_kv
    filled, at B 8, page 16, lengths up to a 4096-token context: H 8 / D
    64 and H_q 8 over H_kv 2 / D 128, fp32 and int8, Sq 1 and 5; unevicted
    tables with windows (the mask does the work), tables compacted by
    evict_interior, two-level views with bs 1 and 16, a batch mixing
    windowed and PAD_START rows.  Bound: max abs error <= PARITY_TOL *
    max(1, max |plain|) on the valid rows.  Reported, not bounded: the
    starts walk without windows against the flat launch, and the two-level
    walk against the flat starts walk, both expected to be exactly
    equal."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 7)
    win, snk = _lc_windows(torch, dev)
    qlens = torch.tensor(LC_PARITY_QLENS, dtype=torch.int32, device=dev)
    B = len(LC_PARITY_LENS)
    cases, exact = [], []
    errs = {"starts": [], "two_level": []}

    def dev_(arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    for Hq, Hkv, D, dtype in LC_PARITY_HEADS:
        tag = f"Hq{Hq}_Hkv{Hkv}_D{D}_{dtype}"
        full, ids = _lc_pool(torch, serving, rng, Hq, Hkv, D, dtype, dev)
        ev, _ = _lc_pool(torch, serving, rng, Hq, Hkv, D, dtype, dev, win,
                         snk)
        for sq in (1, SPEC_D + 1):
            q = torch.randn(B, Hq, sq, D, generator=rng, device=dev)
            ql = qlens if sq > 1 else None
            rows = _valid_rows(torch, qlens, sq, dev)

            def check(walk, name, got, want):
                torch.cuda.synchronize()
                err = float(torch.where(rows, got - want, 0.0).abs().max())
                bound = PARITY_TOL * max(
                    1.0, float(torch.where(rows, want, 0.0).abs().max()))
                cases.append({"walk": walk, "case": f"{tag}_sq{sq}_{name}",
                              "max_abs_err": err, "bound": bound})
                errs[walk].append(err)

            def same(name, a, b):
                torch.cuda.synchronize()
                diff = float(torch.where(rows, a - b, 0.0).abs().max())
                exact.append({"case": f"{tag}_sq{sq}_{name}",
                              "max_abs_diff": diff, "exact": diff == 0.0})

            for pool, label in ((full, "unevicted"), (ev, "compacted")):
                kp, vp = pool.k_pages[0], pool.v_pages[0]
                ks, vs = pool.layer_scales(0)
                kw = dict(q_lengths=ql, k_scales=ks, v_scales=vs)
                t, st, ln = dev_(pool.page_tables_with_starts(ids))
                got = pa.paged_decode_attention(q, kp, vp, t, ln,
                                                page_starts=st, windows=win,
                                                sinks=snk, **kw)
                check("starts", f"{label}_windowed", got,
                      pa.paged_windowed_reference(q, kp, vp, t, ln, ql, st,
                                                  win, snk, D ** -0.5, ks,
                                                  vs))
                if pool is full:
                    same("starts_walk_vs_flat_launch",
                         pa.paged_decode_attention(q, kp, vp, t, ln,
                                                   page_starts=st, **kw),
                         pa.paged_decode_attention(q, kp, vp, t, ln, **kw))
                    continue
                for bs in (1, LC_BLOCK):
                    tl, ln2 = pool.two_level_tables(ids, bs)
                    tl, ln2 = _two_level_on(torch, pa, tl, dev), dev_([ln2])[0]
                    got2 = pa.paged_decode_attention(q, kp, vp, tl, ln2,
                                                     windows=win, sinks=snk,
                                                     **kw)
                    check("two_level", f"compacted_windowed_bs{bs}", got2,
                          pa.paged_windowed_reference(q, kp, vp, tl, ln2, ql,
                                                      None, win, snk,
                                                      D ** -0.5, ks, vs))
                    same(f"two_level_bs{bs}_vs_flat_starts_walk", got2, got)
        del full, ev
    emit({"phase": "longctx_parity", "tolerance": "max abs err <= "
          f"{PARITY_TOL} * max(1, max |plain|), valid rows",
          "lengths": LC_PARITY_LENS, "q_lengths_at_sq5": LC_PARITY_QLENS,
          "windows": win.tolist(), "sinks": snk.tolist(),
          "cases": cases, "exact_identities": exact})
    bad = [c for c in cases if not c["max_abs_err"] <= c["bound"]]
    if bad:
        raise AssertionError(f"long-context walk parity beyond its bound: "
                             f"{bad}")
    return {k: max(v) for k, v in errs.items()}


def make_longctx_requests(serving, np, window=None, motif=False):
    """MAX_BATCH requests of exactly LC_PROMPT tokens and MAX_NEW new
    tokens each (tools/serve_bench.py --context-len's shape): random
    prompts, or one random motif of 6 tokens tiled to LC_PROMPT (the
    --speculate traffic)."""
    rng = np.random.RandomState(SEED + 3)
    if motif:
        m = rng.randint(1, CFG["vocab_size"], size=6).tolist()
        prompts = [(m * -(-LC_PROMPT // 6))[:LC_PROMPT]] * MAX_BATCH
    else:
        prompts = [rng.randint(1, CFG["vocab_size"], size=LC_PROMPT).tolist()
                   for _ in range(MAX_BATCH)]
    return [serving.DecodeRequest(
        prompt=p, max_new_tokens=MAX_NEW, window=window,
        sinks=LC_SINKS if window else 0) for p in prompts]


def _lc_new_pool(serving, cfg, dtype="float32"):
    per_seq = -(-(LC_PROMPT + MAX_NEW) // PAGE_SIZE)
    return serving.KVCachePool(
        num_pages=MAX_BATCH * per_seq + 8, page_size=PAGE_SIZE,
        num_layers=cfg.n_layer, num_heads=cfg.n_head, head_dim=cfg.head_dim,
        num_kv_heads=cfg.num_kv_heads, dtype=dtype)


def _lc_counted(torch, serving, model, cfg, reqs, dtype="float32", **kw):
    """One loop run with every counter zeroed just before it and read just
    after.  Returns (loop, pool, results, wall_s, launches)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    pool = _lc_new_pool(serving, cfg, dtype)
    loop = serving.ContinuousBatchingLoop(model, cfg, pool,
                                          max_batch=MAX_BATCH, **kw)
    torch.cuda.synchronize()
    fa.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    results = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p = pa.paged_decode_attention
    launches = {"flash_fwd": fa.flash_attention.launches,
                "by_variant": dict(p.launches_by_variant),
                "by_table": dict(p.launches_by_table),
                "windowed": p.windowed_launches}
    return loop, pool, results, wall, launches


def _lc_gate(np, cfg, loop, pool, results, launches, name, walk, windowed,
             dtype="float32"):
    """Launch counts by walk = decode steps x n_layer on the arm's walk and
    0 on the others (windowed the same when the arm is windowed), by
    variant verify = spec steps x n_layer and decode the rest; eviction
    and the table walk's width; the pool clean."""
    from paddle_tpu_torch.kernels.paged_attention import TABLE_WALKS, VARIANTS

    n = loop.decode_steps * cfg.n_layer
    sfx = "_i8" if dtype == "int8" else "_f32"
    want = {"flash_fwd": loop.prefill_steps * cfg.n_layer,
            "by_table": {w: n if w == walk else 0 for w in TABLE_WALKS},
            "by_variant": {v: 0 for v in VARIANTS},
            "windowed": n if windowed else 0}
    want["by_variant"]["verify" + sfx] = loop.spec_steps * cfg.n_layer
    want["by_variant"]["decode" + sfx] = (loop.decode_steps
                                          - loop.spec_steps) * cfg.n_layer
    if launches != want or not n:
        raise AssertionError(f"{name}: launches {launches}, want {want}")
    if windowed and not (loop.pages_evicted > 0
                         and loop.max_decode_table_pages <= LC_TABLE_CAP):
        raise AssertionError(
            f"{name}: pages_evicted {loop.pages_evicted}, widest walk "
            f"{loop.max_decode_table_pages} pages (cap {LC_TABLE_CAP})")
    if not windowed and (loop.pages_evicted
                         or loop.max_decode_table_pages <= LC_TABLE_CAP):
        raise AssertionError(f"{name}: an unwindowed run evicted or walked "
                             f"{loop.max_decode_table_pages} pages")
    _check_run(np, cfg, loop, pool, results, name)


def _lc_oracle(serving, params, cfg, reqs):
    """full_decode of the first two requests, windowed as they are."""
    out = []
    for r in reqs[:2]:
        kw = ({} if r.window is None else
              dict(window=r.window, sinks=r.sinks, page_size=PAGE_SIZE))
        toks, rows = serving.full_decode(params, cfg, r.prompt,
                                         r.max_new_tokens, **kw)
        out.append(serving.GeneratedSequence(seq_id=-1, prompt=r.prompt,
                                             tokens=toks, logits=rows))
    return out


def _lc_summary(loop, wall, pool):
    return dict(_spec_summary(loop, wall, MAX_BATCH * MAX_NEW),
                pages_evicted=loop.pages_evicted,
                max_decode_table_pages=loop.max_decode_table_pages,
                used_pages_high_water=pool.stats()["used_pages_high_water"],
                prefill_step_ms_median=1e3 * statistics.median(
                    loop.prefill_step_s))


def _lc_step_times(torch, serving, model, cfg, reqs, table_block=None,
                   steps=8):
    """Decode-step times at the long-context state, outside the loop: one
    prefill of the requests, then 2 * steps decode steps as the loop makes
    them (eviction first for windowed requests).  Wall: the host clock of
    the first `steps`, each ending in a synchronize.  Device: the device's
    own busy time (kernels, copies) per step of the next `steps` under
    torch.profiler, and the paged kernel's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pool = _lc_new_pool(serving, cfg)
    ids = list(range(len(reqs)))
    for s in ids:
        pool.allocate(s)
    tokens = model.prefill_step(pool, ids, [r.prompt for r in reqs]).argmax(
        -1).tolist()
    pos = [len(r.prompt) for r in reqs]
    windowed = reqs[0].window is not None

    def step():
        kw = {"table_block": table_block} if table_block else {}
        if windowed:
            for s, r in zip(ids, reqs):
                pool.evict_interior(s, r.window, r.sinks)
            kw.update(windows=[r.window for r in reqs],
                      sinks=[r.sinks for r in reqs])
        model.decode_step(pool, ids, tokens, pos, **kw)
        for i in ids:
            pos[i] += 1

    walls = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_us = sum(by_name.values())
    if not busy_us:
        raise AssertionError("the profiler saw no device time")
    paged_us = sum(us for k, us in by_name.items() if "paged_attn" in k)
    return {"decode_step_wall_ms_median": 1e3 * statistics.median(walls),
            "decode_step_device_ms": busy_us / 1e3 / steps,
            "paged_kernel_device_ms_per_step": paged_us / 1e3 / steps,
            "table_pages": pool.max_live_pages()}


def phase_longctx(torch, np):
    """Long-context serving at the Transformer-base width with max_length
    4096: MAX_BATCH requests of LC_PROMPT-token prompts, MAX_NEW new tokens
    each, an fp32 pool of page 16.  Four counted arms: (1) no window, flat
    tables; (2) window 512 + 16 sink tokens, flat tables with explicit
    starts; (3) the same through two-level tables of 16-page blocks; (4)
    the same on an int8 pool with speculate=4, on motif-tiled prompts.
    Each is gated by _lc_gate; arms 2-4 also by their tokens against the
    same arm through the plain versions on the card and (two requests)
    against full_decode under the same window, by the near-tie rule, and
    arms 2 and 3 against each other (identical tokens).  Then decode-step
    wall and device time of arms 1-3 side by side."""
    from paddle_tpu_torch import serving

    cfg = serving.DecodeConfig(**dict(CFG, max_length=LC_MAX_LENGTH))
    params = serving.init_decode_params(cfg, seed=SEED)
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    plain = _plain_decoder_cls(serving)(cfg).load_jax_params(params)
    reqs = make_longctx_requests(serving, np)
    wreqs = make_longctx_requests(serving, np, window=LC_WINDOW)
    mreqs = make_longctx_requests(serving, np, window=LC_WINDOW, motif=True)
    out, launches = {}, {}

    def plain_run(rq, dtype="float32", **kw):
        return serving.ContinuousBatchingLoop(
            plain, cfg, _lc_new_pool(serving, cfg, dtype),
            max_batch=MAX_BATCH, **kw).run(rq)

    def compare(name, got, want):
        diff, ties = _compare_tokens(got, want)
        out[name] = {"max_abs_logit_diff": diff, "near_ties": ties}

    loop, pool, res, wall, launches["no_window"] = _lc_counted(
        torch, serving, model, cfg, reqs)
    _lc_gate(np, cfg, loop, pool, res, launches["no_window"],
             "longctx_no_window", "flat", False)
    out["no_window"] = _lc_summary(loop, wall, pool)
    compare("no_window_vs_full_decode", res[:2],
            _lc_oracle(serving, params, cfg, reqs))
    del pool

    w_oracle = _lc_oracle(serving, params, cfg, wreqs)
    res_w = {}
    for arm, walk, kw in (("windowed_flat", "starts", {}),
                          ("windowed_two_level", "two_level",
                           {"table_block": LC_BLOCK})):
        loop, pool, res, wall, launches[arm] = _lc_counted(
            torch, serving, model, cfg, wreqs, **kw)
        _lc_gate(np, cfg, loop, pool, res, launches[arm], arm, walk, True)
        out[arm] = _lc_summary(loop, wall, pool)
        compare(arm + "_vs_plain", res, plain_run(wreqs, **kw))
        compare(arm + "_vs_full_decode", res[:2], w_oracle)
        res_w[arm] = res
        del pool
    flat, two = res_w["windowed_flat"], res_w["windowed_two_level"]
    if [r.tokens for r in flat] != [r.tokens for r in two]:
        raise AssertionError("windowed arms: flat and two-level tokens differ")
    compare("two_level_vs_flat", two, flat)

    arm = "windowed_two_level_int8_spec"
    kw = dict(table_block=LC_BLOCK, speculate=SPEC_D)
    loop, pool, res, wall, launches[arm] = _lc_counted(
        torch, serving, model, cfg, mreqs, dtype="int8", **kw)
    _lc_gate(np, cfg, loop, pool, res, launches[arm], arm, "two_level", True,
             dtype="int8")
    if not loop.drafted_tokens:
        raise AssertionError(f"{arm}: nothing was drafted")
    out[arm] = _lc_summary(loop, wall, pool)
    del pool
    compare(arm + "_vs_plain", res, plain_run(mreqs, "int8", **kw))
    compare(arm + "_vs_full_decode", res[:2],
            _lc_oracle(serving, params, cfg, mreqs))

    steps = {"no_window": _lc_step_times(torch, serving, model, cfg, reqs),
             "windowed_flat": _lc_step_times(torch, serving, model, cfg,
                                             wreqs),
             "windowed_two_level": _lc_step_times(
                 torch, serving, model, cfg, wreqs, table_block=LC_BLOCK)}
    emit({"phase": "longctx", "config": dict(CFG, max_length=LC_MAX_LENGTH),
          "max_batch": MAX_BATCH, "page_size": PAGE_SIZE,
          "prompt_len": LC_PROMPT, "max_new_tokens": MAX_NEW,
          "window": LC_WINDOW, "sinks": LC_SINKS, "table_block": LC_BLOCK,
          "table_pages_cap": LC_TABLE_CAP, "launches": launches,
          "arms": out, "decode_step_times": steps})
    torch.cuda.empty_cache()
    return launches


def _lc_visible(torch, pa, tables, starts, lengths, windows, sinks, dev):
    """[B, 1, 1, S] bool: the keys a decode query (at lengths - 1) sees
    through a flat table and its starts, by the kernel's rule."""
    ps = PAGE_SIZE
    st = torch.as_tensor(starts, device=dev).long()
    ln = torch.as_tensor(lengths, device=dev).long()
    pstart = st.repeat_interleave(ps, dim=1)
    kpos = pstart + torch.arange(ps, device=dev).repeat(st.shape[1])[None]
    qpos = (ln - 1)[:, None]
    vis = (kpos <= qpos) & (kpos < ln[:, None]) & (pstart != pa.PAD_START)
    if windows is not None:
        w = torch.as_tensor(windows, device=dev).long()[:, None]
        k = torch.as_tensor(sinks, device=dev).long()[:, None]
        vis &= (pstart < k) | (pstart + ps > qpos + 1 - w)
    return vis[:, None, None, :]


def phase_longctx_timing(torch, np, errs, launches):
    """Rows 4d and 4e at the long-context decode shape: B 8, H = H_kv 8,
    D 64, page 16, every sequence at LC_PROMPT + MAX_NEW / 2 tokens,
    evicted at window 512 + 16 sinks before its last token was appended
    (34 live pages), fp32; and row 4a on the same pages before eviction
    (a 4096-token-scale context walked whole).  Bound: the K/V rows the
    query sees read once, plus q, o and the table operands, over 3.35
    TB/s, against 4 * D flops per visible key per head over 67 TFLOP/s.
    Library: SDPA over the K/V gathered through the table, with a boolean
    mask of the visible keys (gather not timed)."""
    import torch.nn.functional as F

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 8)
    H, D = CFG["n_head"], CFG["d_model"] // CFG["n_head"]
    scale = D ** -0.5
    B, L = MAX_BATCH, LC_PROMPT + MAX_NEW // 2
    pool = serving.KVCachePool(B * -(-L // PAGE_SIZE) + 4, PAGE_SIZE, 1, H, D)
    ids = list(range(B))
    for s in ids:
        pool.allocate(s)

    def fill(n):
        pg, sl = pool.append_tokens(ids, [n] * B)
        pool.write_kv(0, pg, sl,
                      torch.randn(len(pg), H, D, generator=rng, device=dev),
                      torch.randn(len(pg), H, D, generator=rng, device=dev))

    fill(L)
    kp, vp = pool.k_pages[0], pool.v_pages[0]
    q = torch.randn(B, H, 1, D, generator=rng, device=dev)
    win = torch.full((B,), LC_WINDOW, dtype=torch.int32, device=dev)
    snk = torch.full((B,), LC_SINKS, dtype=torch.int32, device=dev)

    def row(name, replaces, n_launch, err, kernel, plain, t, st, ln, w, k,
            table_bytes, shape):
        vis = _lc_visible(torch, pa, t, st, ln, w, k, dev)
        n_vis = int(vis.sum())
        kg = pa.gather_kv_pages(kp, t)
        vg = pa.gather_kv_pages(vp, t)
        nbytes = 4 * (2 * H * D * n_vis + 2 * B * H * D) + table_bytes
        return _row(name, "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
                    replaces, n_launch, err, device_ms(torch, kernel),
                    device_ms(torch, plain), nbytes, 4 * D * H * n_vis,
                    device_ms(torch, lambda: F.scaled_dot_product_attention(
                        q, kg, vg, attn_mask=vis, scale=scale)),
                    dict(shape, visible_keys=n_vis))

    t, st, ln = (torch.as_tensor(a, device=dev)
                 for a in pool.page_tables_with_starts(ids))
    flat = row("paged_decode", "paddle_tpu/kernels/paged_attention.py:645",
               launches["no_window"]["by_variant"]["decode_f32"], None,
               lambda: pa.paged_decode_attention(q, kp, vp, t, ln),
               lambda: pa.paged_decode_reference(q, kp, vp, t, ln, scale),
               t, st, ln, None, None, 4 * (t.numel() + B),
               {"B": B, "H_q": H, "H_kv": H, "D": D, "page_size": PAGE_SIZE,
                "lengths": [L] * B, "table_pages": t.shape[1]})
    # the loop's order: evict at the length before the fed token
    for s in ids:
        pool.truncate_seq(s, L - 1)
        pool.evict_interior(s, LC_WINDOW, LC_SINKS)
    fill(1)
    t, st, ln = (torch.as_tensor(a, device=dev)
                 for a in pool.page_tables_with_starts(ids))
    shape = {"B": B, "H_q": H, "H_kv": H, "D": D, "page_size": PAGE_SIZE,
             "lengths": [L] * B, "window": LC_WINDOW, "sinks": LC_SINKS,
             "live_pages": t.shape[1]}
    rows = [row(
        "paged_starts_window",
        "paddle_tpu/kernels/paged_attention.py:645",
        launches["windowed_flat"]["by_table"]["starts"], errs["starts"],
        lambda: pa.paged_decode_attention(q, kp, vp, t, ln, page_starts=st,
                                          windows=win, sinks=snk),
        lambda: pa.paged_windowed_reference(q, kp, vp, t, ln, None, st, win,
                                            snk, scale),
        t, st, ln, win, snk, 4 * (2 * t.numel() + 3 * B), shape)]
    tl, _ = pool.two_level_tables(ids, LC_BLOCK)
    tl = _two_level_on(torch, pa, tl, dev)
    rows.append(row(
        "paged_two_level",
        "paddle_tpu/kernels/paged_attention.py:645",
        sum(launches[a]["by_table"]["two_level"]
            for a in ("windowed_two_level", "windowed_two_level_int8_spec")),
        errs["two_level"],
        lambda: pa.paged_decode_attention(q, kp, vp, tl, ln, windows=win,
                                          sinks=snk),
        lambda: pa.paged_windowed_reference(q, kp, vp, tl, ln, None, None,
                                            win, snk, scale),
        t, st, ln, win, snk,
        4 * (tl.l1.numel() + tl.l2.numel() + tl.starts.numel() + 3 * B),
        dict(shape, block_size=LC_BLOCK)))
    emit({"phase": "longctx_timing", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": "SDPA over K/V already gathered through the "
          "table, boolean mask of the visible keys (gather not timed)",
          "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "shape")}
                   for r in [flat] + rows]})
    for r in rows:
        r.pop("shape")
    flat.pop("shape")
    return rows, {k: flat[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}


# -- phase 4: training -----------------------------------------------------

# TransformerConfig() defaults (the base model, vocab 10000) with the
# flash-attention path on and dropout off; Momentum as bench.py builds it
TRAIN_CFG = dict(use_flash_attention=True, dropout=0.0)
TRAIN_BATCH, TRAIN_STEPS, PARITY_BATCH = 32, 10, 2
LR, MOMENTUM = 1e-4, 0.9
LOSS_RTOL = 1e-4       # card vs CPU loss, relative
GRAD_TOL = 2e-3        # card vs CPU grads: max abs err <= GRAD_TOL*max(1, max|g|)
GRAD_NORM_RTOL = 1e-2  # and |a - b| / |b| per leaf (Frobenius norms) ...
GRAD_FLOOR = 1e-4      # ... with |b| floored at GRAD_FLOOR * the largest leaf's
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

# ResNet-50, conv tier, as bench.py builds it (bench.py:167, :178, :327-329)
RESNET_CFG = dict(depth=50, class_num=1000, img_shape=(3, 224, 224),
                  fuse_bn="conv")
RESNET_BATCH, RESNET_STEPS, RESNET_LR = 256, 10, 0.1
CONV_PARITY_BATCH = 4
STATS_RTOL = 1e-4      # card vs CPU MeanOut / VarianceOut, vs max |cpu|
SPREAD = 3.0           # card vs fp64: at most this times the CPU fp32 distance
FAULTS = (1e-2, 1e-3)  # planted forward faults: bn_epilogue's inv * (1 + d);
                       # the first must fail the SPREAD gate
CONV_KERNELS = ("conv_stats", "bn_epilogue")
# bench.py's three ResNet forms (BENCH_FUSE_BN, bench.py:113-117)
FUSE_BN = {"conv": "conv", "unfused": False, "fused": True}


def _flash_counts(fa):
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def build_training(fluid):
    from paddle_tpu_torch.models.transformer import (
        TransformerConfig,
        transformer,
    )

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = transformer(TransformerConfig(**TRAIN_CFG))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


def _persistables(program, scope):
    """{name: host array} of every persistable the startup program made."""
    return {n: scope.find_var(n).cpu().numpy()
            for n, v in program.desc.block(0).vars.items() if v.persistable}


def phase_training(torch, np):
    """The fluid entry points on the card: layers -> Momentum.minimize ->
    Executor.run(startup) -> Executor.run(main) for TRAIN_STEPS steps on
    one fixed batch.  Each attention op is one flash_fwd launch forward
    and one flash_bwd_dq plus one flash_bwd_dkv launch backward: 18 of
    each per step (6 encoder self, 6 decoder self, 6 cross)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa

    main, startup, spec, params_grads = build_training(fluid)
    cfg = spec.extras["config"]
    n_attn = 3 * cfg.n_layer
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    batch = spec.synthetic_batch(TRAIN_BATCH, seed=SEED)
    tokens = TRAIN_BATCH * cfg.max_length

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=batch, fetch_list=[spec.loss],
                        scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.reshape(-1)[0]))
    launches = _flash_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: n_attn * TRAIN_STEPS for k in FLASH_KERNELS}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_med = statistics.median(step_s)
    trace = _trace_training(torch, exe, main, spec, batch, scope, step_med)
    parity = _card_vs_cpu(torch, np, fluid, main, spec, params_grads,
                          init_state)
    emit({"phase": "training", "config": dict(
        cfg.__dict__), "optimizer": {"type": "momentum", "lr": LR,
                                     "momentum": MOMENTUM},
          "batch": [TRAIN_BATCH, cfg.max_length], "params": n_params,
          "main_ops": len(main.desc.block(0).ops),
          "startup_ops": len(startup.desc.block(0).ops),
          "steps": TRAIN_STEPS, "losses": losses, "step_s": step_s,
          "step_ms_median": 1e3 * step_med,
          "tokens_per_s": tokens / step_med, "peak_alloc_gib": peak_gib,
          "launches": launches,
          "launches_per_step": {k: v // TRAIN_STEPS
                                for k, v in launches.items()},
          "trace": trace, "card_vs_cpu": parity})
    return launches, batch, cfg


def _top_kernels(by_name, n):
    """The n largest device times in ms by kernel name, names cut to 160
    characters; names that the cut makes equal are summed, not dropped."""
    ms = {}
    for name, us in by_name.items():
        ms[name[:160]] = ms.get(name[:160], 0.0) + us / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def _trace_training(torch, exe, main, spec, batch, scope, step_wall):
    """One more step under torch.profiler: device busy time from the
    device's own events (kernels, copies, fills) only, against the
    median unprofiled step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[spec.loss], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_s = sum(by_name.values()) / 1e6
    if not busy_s:
        raise AssertionError("the profiler saw no device time")
    flash_us = {k: sum(us for name, us in by_name.items() if k in name)
                for k in FLASH_KERNELS}
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / step_wall,
            "flash_ms": {k: us / 1e3 for k, us in flash_us.items()},
            "flash_share_of_busy": sum(flash_us.values()) / 1e6 / busy_s,
            "device_ms_by_kernel": _top_kernels(by_name, 40)}


def _card_vs_cpu(torch, np, fluid, main, spec, params_grads, init_state):
    """The startup state on the card and on a CPUPlace executor (plain
    versions), one step at PARITY_BATCH on each: the loss and every
    param@GRAD must agree (TF32 is off)."""
    batch = spec.synthetic_batch(PARITY_BATCH, seed=SEED + 1)
    fetch = [spec.loss] + [g for _, g in params_grads]
    got = {}
    for place in ("card", "cpu"):
        exe = fluid.Executor(None if place == "card" else fluid.CPUPlace())
        scope = fluid.Scope()
        exe.load_state(init_state, scope)
        got[place] = exe.run(main, feed=batch, fetch_list=fetch, scope=scope)
    loss_card, loss_cpu = (float(got[p][0].reshape(-1)[0])
                           for p in ("card", "cpu"))
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    # Two gates.  The first, max abs error against max(1, max |g|), is
    # loose where gradients are far below 1, as here.  The second holds
    # each leaf to its own norm, so a wrong dQ, dK or dV fails on the
    # attention projections.  It uses norms, not max abs errors: a ReLU
    # input within rounding of 0 takes the other branch on one side and
    # moves a few entries by a whole term, which is not a fault.  The
    # floor is for the key biases, whose exact gradient is 0 (softmax does
    # not change when one bias is added to every key): their values are
    # rounding noise on both sides.  The floored leaves are reported.
    norms = [float(np.linalg.norm(b)) for b in got["cpu"][1:]]
    floor = GRAD_FLOOR * max(norms)
    worst = worst_rel = 0.0
    worst_name = worst_rel_name = None
    rels, floored = [], []
    for (p, g), a, b, norm in zip(params_grads, got["card"][1:],
                                  got["cpu"][1:], norms):
        ratio = float(np.abs(a - b).max()) / (
            GRAD_TOL * max(1.0, float(np.abs(b).max())))
        if ratio > worst:
            worst, worst_name = ratio, g.name
        if norm < floor:
            floored.append(g.name)
        rel = float(np.linalg.norm(a - b)) / max(norm, floor)
        rels.append((rel, g.name, norm, float(np.abs(b).max())))
        if rel > worst_rel:
            worst_rel, worst_rel_name = rel, g.name
    above = sorted(n for n in norms if n >= floor)
    out = {"batch": PARITY_BATCH, "loss_card": loss_card,
           "loss_cpu": loss_cpu, "loss_rel_err": loss_rel,
           "loss_rtol": LOSS_RTOL, "grads": len(params_grads),
           "grad_tol": f"max abs err <= {GRAD_TOL} * max(1, max |cpu grad|)",
           "worst_grad": worst_name, "worst_grad_err_over_bound": worst,
           "grad_norm_tol": (f"|card - cpu| <= {GRAD_NORM_RTOL} * max(|cpu|,"
                             f" {GRAD_FLOOR} * the largest leaf's |cpu|)"),
           "worst_grad_norm_rel_err": worst_rel,
           "worst_grad_norm": worst_rel_name,
           "top3_norm_rel_err_norm_maxabs": sorted(rels, reverse=True)[:3],
           "floor": floor, "floored": floored,
           "norm_min_median_max_above_floor": [
               above[0], above[len(above) // 2], above[-1]]}
    if (not loss_rel <= LOSS_RTOL or not worst <= 1.0
            or not worst_rel <= GRAD_NORM_RTOL):
        raise AssertionError(f"card vs CPU beyond tolerance: {out}")
    return out


# -- phase 4b: bench.py's Transformer under bf16 AMP -----------------------

# bench.py:180-197: vocab 32000, flash attention, fuse_qkv and the
# config's dropout of 0.1, batch 32 x 256, Momentum as in phase 4; its two
# AMP tiers, BENCH_AMP "1" (bf16 matmul operands, fp32 outputs) and "keep"
# (bf16 outputs: Q/K/V reach the flash kernels in bf16)
BENCH_CFG = dict(src_vocab_size=32000, trg_vocab_size=32000, max_length=256,
                 use_flash_attention=True, fuse_qkv=True)
AMP_TIERS = {"amp1": False, "keep": True}
# AMP card vs CPU (one batch-2 step, dropout 0).  The loss: two bf16 ulps
# (under keep it is bf16).  The gradients: bf16 activations round after
# other summation orders on the two sides, and a ReLU input within a
# rounding of 0 takes the other branch (on the CPU against the JAX package
# 8 of 4096 inputs of one layer did, moving its gradients by 9% in norm),
# so single leaves move by tens of percent where their gradient nearly
# cancels (a cross-attention q bias: 60% on the card); the gate holds the
# median leaf and all leaves together, in norm, relative to the CPU's
AMP_LOSS_RTOL = 2.0 ** -6
AMP_GRAD_NORM_RTOL = 0.1
# each flash call of the keep step against the plain versions: at the
# model's activations dS nearly cancels, fp32 order noise is larger
# against the result's ulp, and up to 0.45% of dQ flipped on the card;
# the moved rounding point flipped 31-46%
MODEL_MISMATCH_SHARE = 0.05
DROPOUT_P = 0.1


def build_bench_transformer(fluid, **over):
    """Under fresh name counters, so that every build names its vars
    alike and one build's state loads into another."""
    from paddle_tpu_torch.core.framework import unique_name_guard
    from paddle_tpu_torch.models.transformer import (
        TransformerConfig,
        transformer,
    )

    main, startup = fluid.Program(), fluid.Program()
    with unique_name_guard(), fluid.program_guard(main, startup):
        spec = transformer(TransformerConfig(**BENCH_CFG, **over))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=LR, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


def _flash_counts_by_dtype(fa):
    return {"flash_fwd": dict(fa.flash_attention.launches_by_dtype),
            "flash_bwd_dq": dict(fa.flash_bwd_dq.launches_by_dtype),
            "flash_bwd_dkv": dict(fa.flash_bwd_dkv.launches_by_dtype)}


def phase_amp_training(torch, np):
    """bench.py's Transformer at full width through the fluid entry
    points, ten steps on one fixed 32 x 256 batch under each AMP tier
    (``fluid.enable_amp("bfloat16")`` and ``keep_output=True``), from one
    startup state.  The flash counters, zeroed before each tier's steps,
    must read 18 per step for each kernel in the tier's dtype (fp32 under
    amp1, bf16 under keep) and 0 in the other; losses finite and falling.
    Ten steps at lr 1e-4 move the loss by less than dropout's step-to-step
    noise, and under keep the loss is bf16 (an ulp of 0.0625 at 10.4); so
    the fall is read without dropout: the startup state and the state
    after the steps each run one step of the dropout-0 build under the
    same tier, and the mean of its per-token costs over the non-pad tokens
    (float64 on the host, from bf16 costs widened exactly under keep) must
    be lower after.
    One more step fetches the fused_attention inputs and the layer_norm
    outputs: bf16 under keep, fp32 under amp1.  Then keep tier card
    against CPU, and dropout on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa

    main, startup, spec, params_grads = build_bench_transformer(fluid)
    cfg = spec.extras["config"]
    n_attn = 3 * cfg.n_layer
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    del scope
    batch = spec.synthetic_batch(TRAIN_BATCH, seed=SEED)
    tokens = TRAIN_BATCH * cfg.max_length
    ops = main.desc.block(0).ops
    # the per-token cost [B, S]: the squeeze of the loss op's output
    cost = next(op.output("Out")[0] for op in ops if op.type == "squeeze2")
    non_pad = (batch[spec.feed_names[2]] != cfg.pad_idx).astype(np.float64)
    eval_main, _, _, _ = build_bench_transformer(fluid, dropout=0.0)
    eval_cost = next(op.output("Out")[0] for op in eval_main.desc.block(0).ops
                     if op.type == "squeeze2")

    def eval_loss(state):
        """Mean per-token cost of one dropout-free step from ``state``."""
        scope = fluid.Scope()
        exe.load_state(state, scope)
        per_token, = exe.run(eval_main, feed=batch, fetch_list=[eval_cost],
                             scope=scope)
        return float((per_token * non_pad).sum() / non_pad.sum())

    acts = {"fused_attention_inputs": [
        n for op in ops if op.type == "fused_attention"
        for slot in ("Q", "K", "V") for n in op.input(slot)],
        "layer_norm_outputs": [op.output("Y")[0] for op in ops
                               if op.type == "layer_norm"]}
    tiers, launches = {}, {}
    for tier, keep in AMP_TIERS.items():
        dtype, other = (("bfloat16", "float32") if keep
                        else ("float32", "bfloat16"))
        fluid.enable_amp("bfloat16", keep_output=keep)
        try:
            scope = fluid.Scope()
            exe.load_state(init_state, scope)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            losses, token_means, step_s = [], [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                loss, per_token = exe.run(main, feed=batch,
                                          fetch_list=[spec.loss, cost],
                                          scope=scope)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(loss.reshape(-1)[0]))
                token_means.append(float((per_token * non_pad).sum()
                                         / non_pad.sum()))
            counts = _flash_counts_by_dtype(fa)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            trained = _persistables(startup, scope)
            evals = [eval_loss(init_state), eval_loss(trained)]
            step_med = statistics.median(step_s)
            trace = _trace_training(torch, exe, main, spec, batch, scope,
                                    step_med)
            vals = exe.run(main, feed=batch, fetch_list=sum(acts.values(),
                                                            []),
                           scope=scope, return_numpy=False)
            act_dtypes = {}
            for what, names in acts.items():
                act_dtypes[what] = sorted({str(vals.pop(0).dtype)
                                           for _ in names})
        finally:
            fluid.disable_amp()
        want = {k: {dtype: n_attn * TRAIN_STEPS, other: 0}
                for k in FLASH_KERNELS}
        if counts != want:
            raise AssertionError(f"{tier}: launches {counts} != {want}")
        if (not all(np.isfinite(losses + token_means + evals))
                or not evals[1] < evals[0]):
            raise AssertionError(f"{tier}: losses not finite and falling: "
                                 f"{losses}, without dropout {evals}")
        if any(d != [f"torch.{dtype}"] for d in act_dtypes.values()):
            raise AssertionError(f"{tier}: activation dtypes {act_dtypes}, "
                                 f"want torch.{dtype}")
        launches[tier] = {k: v[dtype] for k, v in counts.items()}
        tiers[tier] = {
            "enable_amp": {"dtype": "bfloat16", "keep_output": keep},
            "losses": losses, "per_token_cost_means": token_means,
            "dropout_free_loss_before_after": evals,
            "step_s": step_s, "step_ms_median": 1e3 * step_med,
            "tokens_per_s": tokens / step_med, "peak_alloc_gib": peak_gib,
            "launches": counts,
            "launches_per_step": {k: v[dtype] // TRAIN_STEPS
                                  for k, v in counts.items()},
            "activation_dtypes": act_dtypes, "trace": trace}
    emit({"phase": "amp_training", "config": dict(cfg.__dict__),
          "optimizer": {"type": "momentum", "lr": LR, "momentum": MOMENTUM},
          "batch": [TRAIN_BATCH, cfg.max_length],
          "params": sum(int(np.prod(p.shape)) for p, _ in params_grads),
          "main_ops": len(ops), "tiers": tiers})
    emit({"phase": "amp_card_vs_cpu",
          "tiers": {tier: _amp_card_vs_cpu(torch, np, fluid, tier)
                    for tier in AMP_TIERS},
          "dropout_on_card": _dropout_on_card(torch)})
    return launches, batch, cfg


@contextlib.contextmanager
def _recording_flash(fa, calls):
    """Record every flash forward and backward call (inputs and outputs)
    the block runner makes while the context is open."""
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def rec_fwd(q, k, v, causal, scale, k_lengths=None, need_lse=True):
        out, lse = fwd(q, k, v, causal, scale, k_lengths, need_lse)
        calls.append(("fwd", (q, k, v, causal, scale, k_lengths),
                      (out, lse)))
        return out, lse

    def rec_bwd(q, k, v, k_lengths, out, lse, dout, causal, scale):
        grads = bwd(q, k, v, k_lengths, out, lse, dout, causal, scale)
        calls.append(("bwd", (q, k, v, k_lengths, out, lse, dout, causal,
                              scale), grads))
        return grads

    fa.flash_attention_fwd, fa.flash_attention_bwd = rec_fwd, rec_bwd
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd = fwd, bwd


@contextlib.contextmanager
def _moved_rounding_point(fa):
    """The planted fault: the bf16 backward with dS, dS^T and P^T left
    unrounded before their products (``_moved_bwd``), on the card."""
    bwd = fa.flash_attention_bwd

    def moved(q, k, v, k_lengths, out, lse, dout, causal, scale):
        return _moved_bwd(fa, q, k, v, k_lengths, out, lse, dout, causal,
                          scale)

    fa.flash_attention_bwd = moved
    try:
        yield
    finally:
        fa.flash_attention_bwd = bwd


def _calls_vs_plain(torch, fa, calls):
    """Each recorded bf16 flash call of a step against the bf16 plain
    version on the CPU, on the same inputs: max abs error <= BF16_ULP *
    max |plain|, at most MODEL_MISMATCH_SHARE of the elements not
    bit-equal, lse within LSE_RTOL."""
    worst = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    share = dict(worst)
    lse_rel, ok = 0.0, True
    for kind, args, outs in calls:
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        if kind == "fwd":
            q, k, v, causal, scale, kl = cpu
            want = fa.flash_attention_fwd_bf16_reference(q, k, v, causal,
                                                         scale, kl)
            pairs = [("out", outs[0].cpu(), want[0])]
            live = want[1] < 1e29
            lse_rel = max(lse_rel, float(
                ((outs[1].cpu() - want[1]).abs()
                 / want[1].abs().clamp_min(1e-30))[live].max()))
        else:
            want = fa.flash_attention_bwd_reference(*cpu)
            pairs = [(n, g.cpu(), w) for n, g, w in zip(("dq", "dk", "dv"),
                                                        outs, want)]
        for what, got, plain in pairs:
            gate = _bf16_gate(got, plain)
            worst[what] = max(worst[what],
                              gate["max_abs_err"] / gate["bound"])
            share[what] = max(share[what], gate["mismatch_share"])
            ok = (ok and gate["max_abs_err"] <= gate["bound"]
                  and gate["mismatch_share"] <= MODEL_MISMATCH_SHARE)
    return {"calls": len(calls), "max_err_over_bound": worst,
            "max_mismatch_share": share, "lse_rel_err": lse_rel,
            "ok": ok and lse_rel <= LSE_RTOL}


def _amp_card_vs_cpu(torch, np, fluid, tier):
    """Bench's Transformer with dropout 0 (the card's and the CPU's
    generators give different streams) under one AMP tier, one
    PARITY_BATCH step from one startup state on the card and on a CPUPlace
    executor: the loss within AMP_LOSS_RTOL, and the param@GRADs within
    AMP_GRAD_NORM_RTOL of the CPU's in norm, at the median leaf and over
    all leaves together.  Under keep, every flash call of the card's step
    is also held against the bf16 plain versions on the CPU, on its own
    inputs (``_calls_vs_plain``), and the card runs the step again with
    one rounding point moved (``_moved_bwd``): the gate must fail it."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    keep = AMP_TIERS[tier]
    main, startup, spec, params_grads = build_bench_transformer(fluid,
                                                                dropout=0.0)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    batch = spec.synthetic_batch(PARITY_BATCH, seed=SEED + 1)
    fetch = [spec.loss] + [g for _, g in params_grads]
    runs = ("card", "cpu", "planted") if keep else ("card", "cpu")
    got, calls = {}, {"card": [], "planted": []}
    fluid.enable_amp("bfloat16", keep_output=keep)
    try:
        for run in runs:
            exe = fluid.Executor(fluid.CPUPlace() if run == "cpu" else None)
            scope = fluid.Scope()
            exe.load_state(init_state, scope)
            with contextlib.ExitStack() as stack:
                if run == "planted":
                    stack.enter_context(_moved_rounding_point(fa))
                if run != "cpu":
                    stack.enter_context(_recording_flash(fa, calls[run]))
                got[run] = exe.run(main, feed=batch, fetch_list=fetch,
                                   scope=scope)
    finally:
        fluid.disable_amp()
    cpu = got["cpu"]
    loss_cpu = float(cpu[0].reshape(-1)[0])
    norms = [float(np.linalg.norm(b)) for b in cpu[1:]]

    def gates(run):
        vals = got[run]
        loss_rel = abs(float(vals[0].reshape(-1)[0]) - loss_cpu) / abs(
            loss_cpu)
        diffs = [float(np.linalg.norm(a - b))
                 for a, b in zip(vals[1:], cpu[1:])]
        rels = sorted(((d / max(n, 1e-30), g.name, n / max(norms))
                       for (_, g), d, n in zip(params_grads, diffs, norms)),
                      reverse=True)
        median = rels[len(rels) // 2][0]
        joint = float(np.sqrt(sum(d * d for d in diffs))
                      / np.sqrt(sum(n * n for n in norms)))
        out = {"loss": float(vals[0].reshape(-1)[0]),
               "loss_rel_err": loss_rel, "grad_norm_rel_err_median": median,
               "grad_norm_rel_err_all_leaves": joint,
               "top5_rel_err_name_norm_over_largest": rels[:5],
               "ok": loss_rel <= AMP_LOSS_RTOL
               and median <= AMP_GRAD_NORM_RTOL
               and joint <= AMP_GRAD_NORM_RTOL}
        if keep:
            out["flash_calls_vs_plain"] = _calls_vs_plain(torch, fa,
                                                          calls[run])
            out["ok"] = out["ok"] and out["flash_calls_vs_plain"]["ok"]
        return out

    out = {"batch": PARITY_BATCH, "dropout": 0.0, "loss_cpu": loss_cpu,
           "tolerance": (f"loss rel <= {AMP_LOSS_RTOL}; grads |card - cpu| "
                         f"<= {AMP_GRAD_NORM_RTOL} * |cpu| in norm, median "
                         "leaf and all leaves together" + (
                             "; each flash call of the step vs the bf16 "
                             "plain versions on the CPU: max abs err <= "
                             f"{BF16_ULP} * max |plain|, mismatch share <= "
                             f"{MODEL_MISMATCH_SHARE}, lse rel <= "
                             f"{LSE_RTOL}" if keep else "")),
           "card": gates("card")}
    if keep:
        out["planted_moved_rounding"] = gates("planted")
    if not out["card"]["ok"]:
        raise AssertionError(f"{tier} card vs CPU beyond tolerance: {out}")
    if keep and out["planted_moved_rounding"]["ok"]:
        raise AssertionError(f"a moved bf16 rounding point passed: {out}")
    return out


def _dropout_on_card(torch):
    """The dropout rule on the card at the main path's activation shape
    (bf16 [32, 256, 512]), from the executor's kind of generator: keep
    fraction within 5 sigma of 1 - p, gradient g * mask exactly, equal
    masks from equal seeds and other masks from another seed."""
    from paddle_tpu_torch.core.compiler import LoweringContext
    from paddle_tpu_torch.core.registry import OpRegistry

    dev = torch.device("cuda")
    rule = OpRegistry.get("dropout").lower
    attrs = {"dropout_prob": DROPOUT_P, "is_test": False}

    def draw(seed, x):
        ctx = LoweringContext({}, dev, torch.Generator(device=dev)
                              .manual_seed(seed))
        return rule(ctx, {"X": [x]}, attrs)

    x = torch.randn(TRAIN_BATCH, 256, 512, device=dev).to(
        torch.bfloat16).requires_grad_()
    outs = draw(SEED, x)
    mask = outs["Mask"][0].bool()
    n = mask.numel()
    frac = float(mask.float().mean())
    sigma = (DROPOUT_P * (1 - DROPOUT_P) / n) ** 0.5
    g = torch.randn(x.shape, device=dev).to(torch.bfloat16)
    grad, = torch.autograd.grad(outs["Out"][0], x, g)
    out = {"p": DROPOUT_P, "elements": n, "keep_fraction": frac,
           "five_sigma": 5 * sigma,
           "grad_is_g_times_mask": bool(torch.equal(
               grad, torch.where(mask, g, torch.zeros_like(g)))),
           "out_dtype": str(outs["Out"][0].dtype),
           "same_seed_same_mask": bool(torch.equal(
               draw(SEED, x.detach())["Mask"][0], outs["Mask"][0])),
           "other_seed_other_mask": not bool(torch.equal(
               draw(SEED + 1, x.detach())["Mask"][0], outs["Mask"][0]))}
    if not (abs(frac - (1 - DROPOUT_P)) <= 5 * sigma
            and out["grad_is_g_times_mask"] and out["same_seed_same_mask"]
            and out["other_seed_other_mask"]
            and out["out_dtype"] == "torch.bfloat16"):
        raise AssertionError(f"dropout on the card: {out}")
    return out


# -- phase 5: ResNet-50 training --------------------------------------------

def build_resnet(fluid, img_dtype=None, form="conv"):
    """(main, startup, spec, params_grads) of ResNet-50 + Momentum in one
    of the FUSE_BN forms, under fresh name counters so an fp32 and a
    float64 build name every variable alike."""
    from paddle_tpu_torch.core.framework import unique_name_guard
    from paddle_tpu_torch.models import resnet_imagenet

    main, startup = fluid.Program(), fluid.Program()
    with unique_name_guard(), fluid.program_guard(main, startup):
        img = (None if img_dtype is None else fluid.layers.data(
            "image", list(RESNET_CFG["img_shape"]), dtype=img_dtype))
        spec = resnet_imagenet(img=img, **dict(RESNET_CFG,
                                               fuse_bn=FUSE_BN[form]))
        _, params_grads = fluid.optimizer.MomentumOptimizer(
            learning_rate=RESNET_LR, momentum=MOMENTUM).minimize(spec.loss)
    return main, startup, spec, params_grads


def conv_classes(main, batch):
    """The program's conv_bn_add_act ops as distinct shape classes:
    {(N, H, W, C, F, K, stride, padding, residual, act): ops per step},
    with N = batch."""
    block = main.desc.block(0)
    classes = {}
    for op in block.ops:
        if op.type != "conv_bn_add_act":
            continue
        _, C, H, W = block.vars[op.inputs["X"][0]].shape
        Fo, _, K, _ = block.vars[op.inputs["Filter"][0]].shape
        key = (batch, H, W, C, Fo, K, op.attrs["strides"][0],
               op.attrs["paddings"][0], bool(op.inputs.get("Z")),
               op.attrs.get("act") or "")
        classes[key] = classes.get(key, 0) + 1
    return classes


def _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev):
    """Post-ReLU-like x (uniform [0, 1), as the fed image too), the
    layer's N(0, 2 / fan_in) weights, gamma in [0.5, 1.5), beta standard
    normal."""
    x = torch.rand(N, H, W, C, generator=rng, device=dev)
    w = torch.randn(K, K, C, Fo, generator=rng, device=dev) * (
        2.0 / (K * K * C)) ** 0.5
    gamma = torch.rand(Fo, generator=rng, device=dev) + 0.5
    beta = torch.randn(Fo, generator=rng, device=dev)
    return x, w, gamma, beta


def phase_conv_parity(torch, fluid):
    """conv_stats and bn_epilogue against their plain versions, each on
    the same inputs, at every conv shape class of the ResNet-50 program at
    full width — at batch 4 and at the main path's batch — and one case
    off the tiles."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 4)
    main = build_resnet(fluid)[0]
    cases = [k for n in (CONV_PARITY_BATCH, RESNET_BATCH)
             for k in sorted(conv_classes(main, n))]
    cases.append((3, 13, 11, 37, 70, 3, 1, 1, True, "relu"))  # off the tiles
    out_rows, errs = [], {k: [] for k in CONV_KERNELS}

    def record(kernel, case, what, got, want, scale):
        err = float((got - want).abs().max())
        bound = PARITY_TOL * scale
        out_rows.append({"kernel": kernel, "case": case, "what": what,
                         "max_abs_err": err, "bound": bound})
        if what in ("out", "y"):  # the kernels line reports these
            errs[kernel].append(err)

    for N, H, W, C, Fo, K, s, p, res, act in cases:
        name = f"{N}x{H}x{W}x{C}->{Fo} k{K}s{s}p{p}{' +z' if res else ''}" \
               f"{' relu' if act else ''}"
        x, w, gamma, beta = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        out, ssum, ssq = ce.conv_stats(x, w, s, p)
        pout, psum, pssq = ce.conv_stats_reference(x, w, s, p)
        del x, w
        count = pout.shape[0] * pout.shape[1] * pout.shape[2]
        mean = psum / count
        var = torch.clamp(pssq / count - mean * mean, min=0.0)
        inv = torch.rsqrt(var + 1e-5)
        record("conv_stats", name, "out", out, pout,
               max(1.0, float(pout.abs().max())))
        record("conv_stats", name, "sum", ssum, psum, float(psum.abs().max()))
        record("conv_stats", name, "sumsq", ssq, pssq,
               float(pssq.abs().max()))
        del out
        z = torch.randn(pout.shape, generator=rng, device=dev) if res else None
        y = ce.bn_epilogue(pout, mean, inv, gamma, beta, z, act)
        py = ce.bn_epilogue_reference(pout, mean, inv, gamma, beta, z, act)
        record("bn_epilogue", name, "y", y, py,
               max(1.0, float(py.abs().max())))
        del pout, z, y, py
    torch.cuda.empty_cache()
    emit({"phase": "conv_parity", "tolerance": f"max abs err <= {PARITY_TOL}"
          f" * max(1, max |plain|) (out, y); <= {PARITY_TOL} * max |plain| "
          "(sum, sumsq)", "batches": [CONV_PARITY_BATCH, RESNET_BATCH],
          "cases": out_rows})
    bad = [r for r in out_rows if not r["max_abs_err"] <= r["bound"]]
    if bad:
        raise AssertionError(f"conv-epilogue parity beyond its bound: {bad}")
    return {k: max(v) for k, v in errs.items()}


def _conv_counts(ce):
    return {"conv_stats": ce.conv_stats.launches,
            "bn_epilogue": ce.bn_epilogue.launches}


def _conv_counts_by_dtype(ce):
    return {"conv_stats": dict(ce.conv_stats.launches_by_dtype),
            "bn_epilogue": dict(ce.bn_epilogue.launches_by_dtype)}


def phase_resnet(torch, np, fluid):
    """The fluid entry points on the card: resnet_imagenet ->
    Momentum.minimize -> Executor.run(startup) -> Executor.run(main) for
    RESNET_STEPS steps on one fixed batch.  Each of the 53
    conv_bn_add_act ops launches conv_stats and bn_epilogue once a step
    (the backward is plain torch and cuDNN)."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    main, startup, spec, params_grads = build_resnet(fluid)
    n_conv = sum(conv_classes(main, RESNET_BATCH).values())
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    batch = spec.synthetic_batch(RESNET_BATCH, seed=SEED)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ce.reset_launches()
    ce.conv_bn_act.layout_copies = 0
    losses, step_s = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        loss, = exe.run(main, feed=batch, fetch_list=[spec.loss],
                        scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss.reshape(-1)[0]))
    launches = _conv_counts(ce)
    by_dtype = _conv_counts_by_dtype(ce)
    by_shape = dict(ce.conv_stats.launches_by_shape)
    copies = ce.conv_bn_act.layout_copies
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: n_conv * RESNET_STEPS for k in CONV_KERNELS}
    want_by_dtype = {k: {"float32": n, "bfloat16": 0}
                     for k, n in want.items()}
    if n_conv != 53 or launches != want or by_dtype != want_by_dtype:
        raise AssertionError(f"resnet launches {by_dtype} != "
                             f"{want_by_dtype} ({n_conv} conv ops)")
    # conv_stats's shape key: (N, H, W, C, F, K, s, p, dtype)
    want_by_shape = {}
    for key, n in conv_classes(main, RESNET_BATCH).items():
        k = key[:8] + ("float32",)
        want_by_shape[k] = want_by_shape.get(k, 0) + n * RESNET_STEPS
    if by_shape != want_by_shape:
        raise AssertionError(f"conv_stats launches by shape {by_shape} != "
                             f"the program's {want_by_shape}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    step_med = statistics.median(step_s)
    trace = _trace_resnet(torch, exe, main, spec, batch, scope, step_med)
    del scope
    torch.cuda.empty_cache()
    parity = _resnet_card_vs_cpu(np, fluid, main, spec, params_grads,
                                 init_state)
    emit({"phase": "resnet_training", "config": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in RESNET_CFG.items()},
          "optimizer": {"type": "momentum", "lr": RESNET_LR,
                        "momentum": MOMENTUM},
          "batch": RESNET_BATCH, "params": n_params,
          "main_ops": len(main.desc.block(0).ops),
          "startup_ops": len(startup.desc.block(0).ops),
          "steps": RESNET_STEPS, "losses": losses, "step_s": step_s,
          "step_ms_median": 1e3 * step_med,
          "images_per_s": RESNET_BATCH / step_med, "peak_alloc_gib": peak_gib,
          "launches": launches,
          "launches_per_step": {k: v / RESNET_STEPS
                                for k, v in launches.items()},
          "conv_stats_launches_by_shape": [
              {"x": list(k[:4]), "F": k[4], "K": k[5], "stride": k[6],
               "padding": k[7], "launches": n}
              for k, n in sorted(by_shape.items())],
          "layout_copies_per_step": copies / RESNET_STEPS,
          "trace": trace, "card_vs_cpu": parity})
    return launches, by_shape, trace


# kernel names by kind, first match wins: the port's conv-epilogue
# kernels, host-device copies, copies and dtype casts, cuDNN's and
# cuBLAS's convolution and GEMM kernels, reductions, other elementwise
# work
_KINDS = (("conv_stats", ("conv_stats", "stats_reduce_kernel")),
          ("bn_epilogue", ("bn_epilogue",)),
          ("memcpy", ("Memcpy", "Memset")),
          ("copies_and_casts", ("copy", "Copy", "nchwToNhwc", "nhwcToNchw",
                                "ranspose")),
          ("library_conv_and_gemm", ("conv", "Conv", "xmma", "cudnn",
                                     "cutlass", "nvjet", "gemm", "sm90",
                                     "sm80", "dgrad", "wgrad", "fprop")),
          ("reductions", ("reduce_kernel", "Reduce")),
          ("elementwise", ("elementwise", "Elementwise")))


def _trace_resnet(torch, exe, main, spec, batch, scope, step_wall):
    """One more step under torch.profiler: device busy time from the
    device's own events only; each conv kernel's summed ms (conv_stats is
    its GEMM and its partial-sum reduction)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=batch, fetch_list=[spec.loss], scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    busy_s = sum(by_name.values()) / 1e6
    if not busy_s:
        raise AssertionError("the profiler saw no device time")
    marks = {"conv_stats": ("conv_stats", "stats_reduce_kernel"),
             "bn_epilogue": ("bn_epilogue",)}
    own_us = {k: sum(us for name, us in by_name.items()
                     if any(m in name for m in ms))
              for k, ms in marks.items()}
    # layout changes and copies (dtype casts are elementwise copies too)
    copy_marks = ("copy", "Copy", "nchwToNhwc", "nhwcToNchw", "ranspose")
    copy_us = {name: us for name, us in by_name.items()
               if any(m in name for m in copy_marks)}
    by_kind = {}
    for name, us in by_name.items():
        kind = next((k for k, ms in _KINDS if any(m in name for m in ms)),
                    "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / step_wall,
            "kernel_ms_per_step": {k: us / 1e3 for k, us in own_us.items()},
            "kernels_share_of_busy": sum(own_us.values()) / 1e6 / busy_s,
            "device_ms_by_kind": by_kind,
            "copy_and_layout_ms": sum(copy_us.values()) / 1e3,
            "copy_and_layout_kernels": _top_kernels(copy_us, 8),
            "device_ms_by_kernel": _top_kernels(by_name, 40)}


def _distances(np, got, want):
    """(norm of all errors over norm of all leaves, worst leaf's norm
    error over its own norm floored at GRAD_FLOOR of the largest)."""
    norms = [float(np.linalg.norm(w)) for w in want]
    floor = GRAD_FLOOR * max(norms)
    errs = [float(np.linalg.norm(np.asarray(g, np.float64) - w))
            for g, w in zip(got, want)]
    total = (sum(e * e for e in errs) / sum(n * n for n in norms)) ** 0.5
    worst = max(zip((e / max(n, floor) for e, n in zip(errs, norms)),
                    range(len(errs))))
    return float(total), worst[0], worst[1]


def _phase4_gates(np, got, want):
    """Phase 4's gradient gates as ratios: the worst max abs error over
    GRAD_TOL * max(1, max |want|), and the worst norm error over the
    leaf's norm floored at GRAD_FLOOR of the largest."""
    norms = [float(np.linalg.norm(b)) for b in want]
    floor = GRAD_FLOOR * max(norms)
    maxabs = max(float(np.abs(a - b).max())
                 / (GRAD_TOL * max(1.0, float(np.abs(b).max())))
                 for a, b in zip(got, want))
    norm = max(float(np.linalg.norm(a - b)) / max(n, floor)
               for a, b, n in zip(got, want, norms))
    return {"maxabs_err_over_bound": maxabs, "worst_norm_rel_err": norm}


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


def _by(np, key, gnames, got, want):
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


def _planted_fault(plain, d):
    """bn_epilogue with its inv scaled by 1 + d: a forward fault (the
    backward still takes the true inv)."""
    def bn_epilogue(out, mean, inv, *args):
        return plain(out, mean, inv * (1.0 + d), *args)
    # plain's body counts under the module name
    bn_epilogue.launches = 0
    bn_epilogue.launches_by_dtype = dict(plain.launches_by_dtype)
    return bn_epilogue


def _resnet_card_vs_cpu(np, fluid, main, spec, params_grads, init_state):
    """One PARITY_BATCH step from the startup state on the card, on the
    CPU executor, and on the CPU through the float64 build of the same
    program.  The loss and the moving statistics are held to the CPU's
    fp32 values; the gradients to the CPU fp32 run's own distance from
    float64 (module docstring, phase 5), with each run's distance by
    stage and by op from the loss end.  Then the card runs again with
    each planted fault of FAULTS, and the first must fail the gradient
    gate."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    batch = spec.synthetic_batch(PARITY_BATCH, seed=SEED + 1)
    stats = sorted(n for n in init_state if ".mean_" in n or ".var_" in n)
    gnames = [g.name for _, g in params_grads]
    fetch = [spec.loss.name] + gnames + stats
    main64, _, spec64, _ = build_resnet(fluid, "float64")
    feed64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
              for k, v in batch.items()}
    runs = [("card", main, batch), ("cpu", main, batch),
            ("cpu64", main64, feed64)]
    runs += [(d, main, batch) for d in FAULTS]
    plain = ce.bn_epilogue
    got = {}
    for place, prog, feed in runs:
        exe = fluid.Executor(fluid.CPUPlace() if place in ("cpu", "cpu64")
                             else None)
        scope = fluid.Scope()
        exe.load_state(init_state, scope)
        if place in FAULTS:
            ce.bn_epilogue = _planted_fault(plain, place)
        try:
            vals = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        finally:
            ce.bn_epilogue = plain
        got[place] = {"loss": float(vals[0].reshape(-1)[0]),
                      "grads": vals[1:1 + len(gnames)],
                      "stats": vals[1 + len(gnames):]}
    card, cpu, exact = got["card"], got["cpu"], got["cpu64"]

    def loss_rel(run):
        return abs(run["loss"] - cpu["loss"]) / abs(cpu["loss"])

    def stats_rel(run):
        return max((float(np.abs(a - b).max()) / float(np.abs(b).max()), n)
                   for n, a, b in zip(stats, run["stats"], cpu["stats"]))

    d_card = _distances(np, card["grads"], exact["grads"])
    d_cpu = _distances(np, cpu["grads"], exact["grads"])

    def within_spread(d):
        return d[0] <= SPREAD * d_cpu[0] and d[1] <= SPREAD * d_cpu[1]

    faults = {}
    for d in FAULTS:
        dist = _distances(np, got[d]["grads"], exact["grads"])
        faults[f"inv*(1+{d:g})"] = {
            "loss_rel_err": loss_rel(got[d]),
            "stats_worst_rel_err": stats_rel(got[d])[0],
            "grad_dist_vs_fp64": dist[:2],
            "over_cpu_fp32": (dist[0] / d_cpu[0], dist[1] / d_cpu[1]),
            "grad_gate_passes": within_spread(dist)}
    stat = stats_rel(card)
    out = {"batch": PARITY_BATCH, "loss_card": card["loss"],
           "loss_cpu": cpu["loss"], "loss_cpu64": exact["loss"],
           "loss_rel_err": loss_rel(card), "loss_rtol": LOSS_RTOL,
           "stats": len(stats), "stats_worst_rel_err": stat[0],
           "stats_worst": stat[1], "stats_rtol": STATS_RTOL,
           "grads": len(gnames),
           "grad_gate": f"card's distance from float64 <= {SPREAD} x the "
                        "CPU fp32 run's, all leaves and worst leaf",
           "grad_dist_card_vs_fp64": {"all": d_card[0], "worst_leaf":
                                      d_card[1],
                                      "worst": gnames[d_card[2]]},
           "grad_dist_cpu_vs_fp64": {"all": d_cpu[0], "worst_leaf": d_cpu[1],
                                     "worst": gnames[d_cpu[2]]},
           "card_over_cpu_fp32": (d_card[0] / d_cpu[0],
                                  d_card[1] / d_cpu[1]),
           "grad_dist_vs_fp64_by_stage": {
               k: _by(np, _stage, gnames, got[k]["grads"], exact["grads"])
               for k in ("cpu", "card")},
           "grad_dist_vs_fp64_by_op": {
               k: _by(np, int, gnames, got[k]["grads"], exact["grads"])
               for k in ("cpu", "card")},
           "planted_faults": faults,
           # phase 4's two gradient gates, reported, not gated on: the
           # CPU's own fp32 run does not meet them against float64
           "phase4_gates_card_vs_cpu": _phase4_gates(np, card["grads"],
                                                     cpu["grads"]),
           "phase4_gates_cpu_vs_fp64": _phase4_gates(np, cpu["grads"],
                                                     exact["grads"])}
    if (not loss_rel(card) <= LOSS_RTOL or not stat[0] <= STATS_RTOL
            or not within_spread(d_card)):
        raise AssertionError(f"resnet card vs CPU beyond tolerance: {out}")
    if faults[f"inv*(1+{FAULTS[0]:g})"]["grad_gate_passes"]:
        raise AssertionError(f"the gradient gate let a planted fault "
                             f"through: {faults}")
    return out


# -- phase 5b: ResNet-50 under bf16 AMP --------------------------------------

# the runs, in order: bench.py's three forms under its two AMP tiers
# (BENCH_AMP "1", bf16 conv operands with fp32 outputs, and the tuner's
# "keep", bf16 outputs), fuse_bn=True under amp1 only
RESNET_AMP_RUNS = (("conv", "amp1"), ("conv", "keep"), ("unfused", "amp1"),
                   ("unfused", "keep"), ("fused", "amp1"))
# the rounded-statistics fault moves y by the rounding noise of the batch
# mean and variance, which shrinks as 1/sqrt(M) (M = N * Ho * Wo): the
# share-of-elements gate sees it where M is small (4.3-11.3% of y at M =
# 72-288 on the CPU), so it is required to fail there, and reported at
# every shape
ROUNDED_STATS_GATED_M = 4096
# the keep step card against the CPU (batch 2, at the startup state): in
# bf16 the step is chaotic.  On the CPU, the image scaled by 1 + 2^-20
# moved the keep loss by 1.6% and the gradients by 117% (median leaf) and
# 121% (all leaves) in norm, where in fp32 the same perturbation moved the
# gradients by 2.8%: a rounding that flips early reaches every later
# batch norm.  So the model-level gates are loose: the loss within 2^-5,
# and the gradients no farther from the CPU's than RESNET_AMP_SPREAD times
# the CPU's own distance from its perturbed run, measured in the same
# call; they catch gross faults only.  The tight gate is per call.
RESNET_AMP_LOSS_RTOL = 2.0 ** -5
RESNET_AMP_SPREAD = 1.5
RESNET_AMP_PERTURB = 2.0 ** -20


def phase_conv_parity_bf16(torch, fluid):
    """The bf16 entries of conv_stats and bn_epilogue against their bf16
    plain versions on the same inputs, at every conv shape class of the
    ResNet-50 program at batch 4 and at the main path's batch, and one
    case off the tiles.  ``out`` and y: max abs error <= BF16_ULP * max
    |plain| with at most MISMATCH_SHARE of the elements not bit-equal;
    sum and sumsq within PARITY_TOL of the vector's largest.  Two planted
    faults against the plain y: the statistics taken from the rounded
    ``out`` (run through the bf16 kernel; required to fail where M <=
    ROUNDED_STATS_GATED_M, reported everywhere), and the residual left
    unrounded in fp32 (required to fail at every shape with a residual).
    Then the bf16 kernels against the fp32 kernels on the same
    bf16-valued inputs: |out16 - out32| <= 2^-8 |out32| and |y16 - y32|
    <= 2^-8 (|y32| + |inv gamma out32|) * 1.01 elementwise (one rounding
    of at most half a bf16 ulp each), plus 1e-5 of the tensor's largest
    for fp32 order."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rng = torch.Generator(device=dev).manual_seed(SEED + 8)
    main = build_resnet(fluid)[0]
    cases = [k for n in (CONV_PARITY_BATCH, RESNET_BATCH)
             for k in sorted(conv_classes(main, n))]
    cases.append((3, 13, 11, 37, 70, 3, 1, 1, True, "relu"))  # off the tiles
    rows, faults, vs_fp32 = [], [], []
    errs = {k: [] for k in CONV_KERNELS}
    for N, H, W, C, Fo, K, s, p, res, act in cases:
        name = f"{N}x{H}x{W}x{C}->{Fo} k{K}s{s}p{p}{' +z' if res else ''}" \
               f"{' relu' if act else ''}"
        x, w, gamma, beta = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        x, w = x.to(bf16), w.to(bf16)
        out, ssum, ssq = ce.conv_stats(x, w, s, p)
        pout, psum, pssq = ce.conv_stats_reference(x, w, s, p)
        M = pout.shape[0] * pout.shape[1] * pout.shape[2]
        gate = _bf16_gate(out, pout)
        rows.append({"kernel": "conv_stats_bf16", "case": name, "what": "out",
                     **gate})
        errs["conv_stats"].append(gate["max_abs_err"])
        for what, got, want in (("sum", ssum, psum), ("sumsq", ssq, pssq)):
            err = float((got - want).abs().max())
            bound = PARITY_TOL * float(want.abs().max())
            rows.append({"kernel": "conv_stats_bf16", "case": name,
                         "what": what, "max_abs_err": err, "bound": bound,
                         "ok": err <= bound})
        mean, var = ce._batch_stats(pout, psum, pssq)
        inv = torch.rsqrt(var + 1e-5)
        z32 = (torch.randn(pout.shape, generator=rng, device=dev) if res
               else None)
        z = None if z32 is None else z32.to(bf16)
        y = ce.bn_epilogue(pout, mean, inv, gamma, beta, z, act)
        py = ce.bn_epilogue_reference(pout, mean, inv, gamma, beta, z, act)
        gate = _bf16_gate(y, py)
        rows.append({"kernel": "bn_epilogue_bf16", "case": name, "what": "y",
                     **gate})
        errs["bn_epilogue"].append(gate["max_abs_err"])
        # the planted faults
        rvar, rmean = torch.var_mean(out.float(), dim=(0, 1, 2),
                                     unbiased=False)
        bad = ce.bn_epilogue(out, rmean, torch.rsqrt(rvar + 1e-5), gamma,
                             beta, z, act)
        planted = _bf16_gate(bad, py)
        faults.append({"fault": "statistics from the rounded out",
                       "case": name, "M": M,
                       "mismatch_share": planted["mismatch_share"],
                       "caught": not planted["ok"],
                       "required": M <= ROUNDED_STATS_GATED_M})
        if res:
            bad = ce.bn_epilogue_reference(pout.float(), mean, inv, gamma,
                                           beta, z32, act).to(bf16)
            planted = _bf16_gate(bad, py)
            faults.append({"fault": "residual unrounded", "case": name,
                           "M": M,
                           "mismatch_share": planted["mismatch_share"],
                           "caught": not planted["ok"], "required": True})
        del bad, pout, py
        # the bf16 kernels against the fp32 kernels on the same values
        out32, s32, q32 = ce.conv_stats(x.float(), w.float(), s, p)
        m32, v32 = ce._batch_stats(out32, s32, q32)
        i32 = torch.rsqrt(v32 + 1e-5)
        y32 = ce.bn_epilogue(out32, m32, i32, gamma, beta,
                             None if z is None else z.float(), act)
        m16, v16 = ce._batch_stats(out, ssum, ssq)
        y16 = ce.bn_epilogue(out, m16, torch.rsqrt(v16 + 1e-5), gamma, beta,
                             z, act)
        out_bound = 2.0 ** -8 * out32.abs() + 1e-5 * float(
            out32.abs().max())
        y_bound = (2.0 ** -8 * 1.01 * (y32.abs() + (i32 * gamma).abs()
                                       * out32.abs())
                   + 1e-5 * float(y32.abs().max()))
        out_ratio = float(((out.float() - out32).abs() / out_bound).max())
        y_ratio = float(((y16.float() - y32).abs() / y_bound).max())
        vs_fp32.append({"case": name, "out_err_over_bound": out_ratio,
                        "y_err_over_bound": y_ratio,
                        "sums_equal": bool(torch.equal(ssum, s32)
                                           and torch.equal(ssq, q32)),
                        "ok": out_ratio <= 1.0 and y_ratio <= 1.0})
        del x, w, out, out32, y, y16, y32, z, z32
    torch.cuda.empty_cache()
    emit({"phase": "conv_parity_bf16", "tolerance": (
              f"out, y: max abs err <= {BF16_ULP} * max |plain| and at most "
              f"{MISMATCH_SHARE} of the elements not bit-equal; sum, sumsq: "
              f"max abs err <= {PARITY_TOL} * max |plain|"),
          "batches": [CONV_PARITY_BATCH, RESNET_BATCH], "cases": rows,
          "planted_faults": faults, "vs_fp32_kernels": vs_fp32,
          "vs_fp32_tolerance": (
              "|out16 - out32| <= 2^-8 |out32| + 1e-5 max|out32|; |y16 - "
              "y32| <= 1.01 * 2^-8 (|y32| + |inv gamma| |out32|) + 1e-5 "
              "max|y32|, elementwise")})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"bf16 conv-epilogue parity beyond its bound: "
                             f"{bad}")
    missed = [f for f in faults if f["required"] and not f["caught"]]
    if missed or not any(f["required"] for f in faults):
        raise AssertionError(f"a planted rounding fault passed the gate: "
                             f"{missed}")
    bad = [c for c in vs_fp32 if not c["ok"]]
    if bad:
        raise AssertionError(f"bf16 conv kernels beyond their bound against "
                             f"the fp32 kernels: {bad}")
    return {k: max(v) for k, v in errs.items()}


def _resnet_act_names(main):
    """Y of every conv op (conv_bn_add_act's Y, conv2d's Output) and every
    batch-norm op (batch_norm's and fused_bn_add_act's Y)."""
    ops = main.desc.block(0).ops
    return {"conv": [n for op in ops
                     if op.type in ("conv_bn_add_act", "conv2d")
                     for n in op.output("Y" if op.type == "conv_bn_add_act"
                                        else "Output")],
            "batch_norm": [op.output("Y")[0] for op in ops
                           if op.type in ("batch_norm", "fused_bn_add_act")]}


def phase_resnet_amp(torch, np, fluid):
    """ResNet-50 at full width (batch 256, Momentum(0.1, 0.9)) through the
    fluid entry points under bf16 AMP: each run of RESNET_AMP_RUNS trains
    RESNET_STEPS steps on one fixed batch from its form's startup state.
    The conv counters, zeroed before each run, must read 53 launches a
    step of conv_stats_bf16 and of bn_epilogue_bf16 and none of the fp32
    entries for the conv tier under either tier (``mxu_operands`` casts X
    to bf16 under both), and none at all for the other forms; losses
    finite and the last below the first.  Median step, images/s, peak
    allocated memory and a profiled step per run; then one step at
    PARITY_BATCH fetches Y of every conv and batch-norm op: bf16 under
    keep, fp32 under amp1, with every persistable (master weights,
    velocities, moving statistics) fp32."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    runs, launches = {}, {}
    for form, tier in RESNET_AMP_RUNS:
        keep = AMP_TIERS[tier]
        main, startup, spec, params_grads = build_resnet(fluid, form=form)
        n_conv = sum(op.type in ("conv_bn_add_act", "conv2d")
                     for op in main.desc.block(0).ops)
        acts = _resnet_act_names(main)
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        batch = spec.synthetic_batch(RESNET_BATCH, seed=SEED)
        small = spec.synthetic_batch(PARITY_BATCH, seed=SEED + 1)
        fluid.enable_amp("bfloat16", keep_output=keep)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ce.reset_launches()
            ce.conv_bn_act.layout_copies = 0
            losses, step_s = [], []
            for _ in range(RESNET_STEPS):
                t0 = time.perf_counter()
                loss, = exe.run(main, feed=batch, fetch_list=[spec.loss],
                                scope=scope)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(loss.reshape(-1)[0]))
            counts = _conv_counts_by_dtype(ce)
            copies = ce.conv_bn_act.layout_copies
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            step_med = statistics.median(step_s)
            trace = _trace_resnet(torch, exe, main, spec, batch, scope,
                                  step_med)
            vals = exe.run(main, feed=small,
                           fetch_list=acts["conv"] + acts["batch_norm"],
                           scope=scope, return_numpy=False)
            act_dtypes = {
                "conv": sorted({str(v.dtype) for v in vals[
                    :len(acts["conv"])]}),
                "batch_norm": sorted({str(v.dtype) for v in vals[
                    len(acts["conv"]):]})}
            del vals
            state_dtypes = sorted({str(scope.find_var(n).dtype)
                                   for n, v in startup.desc.block(0)
                                   .vars.items() if v.persistable})
        finally:
            fluid.disable_amp()
        del scope
        torch.cuda.empty_cache()
        n = n_conv * RESNET_STEPS if form == "conv" else 0
        want = {k: {"float32": 0, "bfloat16": n} for k in CONV_KERNELS}
        name = f"{form}_{tier}"
        if n_conv != 53 or counts != want:
            raise AssertionError(f"{name}: launches {counts} != {want} "
                                 f"({n_conv} conv ops)")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: losses not finite and falling: "
                                 f"{losses}")
        dt = "torch.bfloat16" if keep else "torch.float32"
        if (act_dtypes["conv"] != [dt]
                or act_dtypes["batch_norm"] not in ([dt], [])
                or (form != "conv") != bool(act_dtypes["batch_norm"])
                or state_dtypes != ["torch.float32"]):
            raise AssertionError(f"{name}: activation dtypes {act_dtypes}, "
                                 f"state {state_dtypes}; want {dt}")
        launches[name] = {k: v["bfloat16"] for k, v in counts.items()}
        runs[name] = {
            "fuse_bn": FUSE_BN[form],
            "enable_amp": {"dtype": "bfloat16", "keep_output": keep},
            "main_ops": len(main.desc.block(0).ops),
            "losses": losses, "step_s": step_s,
            "step_ms_median": 1e3 * step_med,
            "images_per_s": RESNET_BATCH / step_med,
            "peak_alloc_gib": peak_gib, "launches": counts,
            "launches_per_step": {k: v["bfloat16"] / RESNET_STEPS
                                  for k, v in counts.items()},
            "conv_tier_layout_copies_per_step": copies / RESNET_STEPS,
            "activation_dtypes": act_dtypes,
            "activation_dtypes_batch": PARITY_BATCH,
            "persistable_dtypes": state_dtypes, "trace": trace}
    emit({"phase": "resnet_amp_training", "config": {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in RESNET_CFG.items() if k != "fuse_bn"},
          "optimizer": {"type": "momentum", "lr": RESNET_LR,
                        "momentum": MOMENTUM},
          "batch": RESNET_BATCH, "steps": RESNET_STEPS, "runs": runs})
    emit({"phase": "resnet_amp_card_vs_cpu",
          **_resnet_amp_card_vs_cpu(torch, np, fluid)})
    return launches


@contextlib.contextmanager
def _recording_conv(nn_ops, calls):
    """Record every conv_bn_add_act call of the conv-epilogue kernels the
    block runner makes while the context is open: inputs (x, w, gamma,
    beta, z and the attributes) and outputs (y, mean, var), detached."""
    trainable = nn_ops.conv_bn_act_trainable

    def rec(x, w, gamma, beta, z=None, **kw):
        y, mean, var = trainable(x, w, gamma, beta, z, **kw)
        calls.append(([None if t is None else t.detach()
                       for t in (x, w, gamma, beta, z)], kw,
                      [t.detach() for t in (y, mean, var)]))
        return y, mean, var

    nn_ops.conv_bn_act_trainable = rec
    try:
        yield
    finally:
        nn_ops.conv_bn_act_trainable = trainable


@contextlib.contextmanager
def _rounded_stats_fault(ce):
    """The planted fault on the card: conv_bn_act takes its batch
    statistics from the rounded conv output (two-pass), as the JAX
    reference composition does."""
    plain = ce._batch_stats

    def rounded(out, ssum, ssq):
        import torch

        var, mean = torch.var_mean(out.float(), dim=(0, 1, 2),
                                   unbiased=False)
        return mean, var

    ce._batch_stats = rounded
    try:
        yield
    finally:
        ce._batch_stats = plain


def _conv_calls_vs_plain(torch, ce, calls):
    """Each recorded conv_bn_add_act call against the bf16 plain versions
    on the CPU, on its own inputs: the conv output through
    conv_stats_reference, the statistics from its fp32 sums, y through
    bn_epilogue_reference.  y: max abs error <= BF16_ULP * max |plain| and
    at most MISMATCH_SHARE of its elements not bit-equal; mean and var
    within PARITY_TOL of the vector's largest."""
    worst, share, stats, ok = 0.0, 0.0, 0.0, True
    for (x, w, gamma, beta, z), kw, (y, mean, var) in calls:
        x, w, gamma, beta = (t.cpu() for t in (x, w, gamma, beta))
        z = None if z is None else z.cpu()
        pout, psum, pssq = ce.conv_stats_reference(x, w, kw["stride"],
                                                   kw["padding"])
        pmean, pvar = ce._batch_stats(pout, psum, pssq)
        py = ce.bn_epilogue_reference(pout, pmean,
                                      torch.rsqrt(pvar + kw["eps"]), gamma,
                                      beta, z, kw["act"])
        gate = _bf16_gate(y.cpu(), py)
        worst = max(worst, gate["max_abs_err"] / gate["bound"])
        share = max(share, gate["mismatch_share"])
        for got, want in ((mean, pmean), (var, pvar)):
            stats = max(stats, float((got.cpu() - want).abs().max())
                        / float(want.abs().max()))
        ok = ok and gate["ok"]
    return {"calls": len(calls), "y_max_err_over_bound": worst,
            "y_max_mismatch_share": share, "stats_max_rel_err": stats,
            "ok": ok and stats <= PARITY_TOL}


def _resnet_amp_card_vs_cpu(torch, np, fluid):
    """The conv tier under keep, one PARITY_BATCH step from one startup
    state on the card, on a CPUPlace executor, and on the CPU with the
    image scaled by 1 + RESNET_AMP_PERTURB.  The model-level gates: the
    card's loss within RESNET_AMP_LOSS_RTOL of the CPU's, and its
    param@GRADs no farther from the CPU's in norm (median leaf, and all
    leaves together) than RESNET_AMP_SPREAD times the perturbed CPU run
    lies (the step is chaotic in bf16).  The tight gate: every
    conv-epilogue call of the card's step against the bf16 plain versions
    on its own inputs (``_conv_calls_vs_plain``); the card then runs the
    step again with the statistics taken from the rounded conv output,
    and that per-call gate must fail."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce
    from paddle_tpu_torch.ops import nn_ops

    main, startup, spec, params_grads = build_resnet(fluid)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    del scope
    batch = spec.synthetic_batch(PARITY_BATCH, seed=SEED + 1)
    image = spec.feed_names[0]
    perturbed = dict(batch)
    perturbed[image] = (batch[image] * (1.0 + RESNET_AMP_PERTURB)).astype(
        batch[image].dtype)
    fetch = [spec.loss] + [g for _, g in params_grads]
    got, calls = {}, {"card": [], "planted": []}
    fluid.enable_amp("bfloat16", keep_output=True)
    try:
        for run in ("card", "cpu", "cpu_perturbed", "planted"):
            exe = fluid.Executor(fluid.CPUPlace() if run.startswith("cpu")
                                 else None)
            scope = fluid.Scope()
            exe.load_state(init_state, scope)
            with contextlib.ExitStack() as stack:
                if run == "planted":
                    stack.enter_context(_rounded_stats_fault(ce))
                if run in calls:
                    stack.enter_context(_recording_conv(nn_ops, calls[run]))
                got[run] = exe.run(main, feed=perturbed
                                   if run == "cpu_perturbed" else batch,
                                   fetch_list=fetch, scope=scope)
    finally:
        fluid.disable_amp()
    cpu = got["cpu"]
    loss_cpu = float(cpu[0].reshape(-1)[0])
    norms = [float(np.linalg.norm(b)) for b in cpu[1:]]

    def distances(run):
        vals = got[run]
        loss = float(vals[0].reshape(-1)[0])
        diffs = [float(np.linalg.norm(a - b))
                 for a, b in zip(vals[1:], cpu[1:])]
        rels = sorted(((d / max(n, 1e-30), g.name, n / max(norms))
                       for (_, g), d, n in zip(params_grads, diffs, norms)),
                      reverse=True)
        return {"loss": loss, "loss_rel_err": abs(loss - loss_cpu)
                / abs(loss_cpu),
                "grad_norm_rel_err_median": rels[len(rels) // 2][0],
                "grad_norm_rel_err_all_leaves": float(
                    np.sqrt(sum(d * d for d in diffs))
                    / np.sqrt(sum(n * n for n in norms))),
                "grads_finite": all(bool(np.isfinite(a).all())
                                    for a in vals[1:]),
                "top5_rel_err_name_norm_over_largest": rels[:5]}

    spread = distances("cpu_perturbed")

    def gates(run):
        d = distances(run)
        d["model_ok"] = (
            d["grads_finite"] and d["loss_rel_err"] <= RESNET_AMP_LOSS_RTOL
            and all(d[k] <= RESNET_AMP_SPREAD * spread[k]
                    for k in ("grad_norm_rel_err_median",
                              "grad_norm_rel_err_all_leaves")))
        d["conv_calls_vs_plain"] = _conv_calls_vs_plain(torch, ce,
                                                        calls[run])
        return d

    out = {"form": "conv", "tier": "keep", "batch": PARITY_BATCH,
           "loss_cpu": loss_cpu,
           "tolerance": (f"loss rel <= {RESNET_AMP_LOSS_RTOL}; grads "
                         f"|card - cpu| <= {RESNET_AMP_SPREAD} x |cpu "
                         f"perturbed (image * (1 + {RESNET_AMP_PERTURB}))"
                         " - cpu| in norm, median leaf and all leaves "
                         "together; each conv_bn_add_act call vs the bf16 "
                         "plain versions on the CPU: y max abs err <= "
                         f"{BF16_ULP} * max |plain|, mismatch share <= "
                         f"{MISMATCH_SHARE}, mean and var <= {PARITY_TOL} "
                         "of the largest"),
           "cpu_perturbed": spread, "card": gates("card"),
           "planted_rounded_statistics": gates("planted")}
    card = out["card"]
    if not (card["model_ok"] and card["conv_calls_vs_plain"]["ok"]
            and card["conv_calls_vs_plain"]["calls"] == 53):
        raise AssertionError(f"resnet keep card vs CPU beyond tolerance: "
                             f"{out}")
    if out["planted_rounded_statistics"]["conv_calls_vs_plain"]["ok"]:
        raise AssertionError(f"the rounded-statistics fault passed the "
                             f"per-call gate: {out}")
    return out


def phase_conv_timing_bf16(torch, conv_err, launches):
    """conv_stats_bf16 and bn_epilogue_bf16 at the fp32 rows' shapes (3x3/1
    pad 1 [256, 56, 56, 64] -> 64, 1x1/1 -> 256, the 7x7/2 pad 3 stem;
    the [256, 56, 56, 256] epilogue with the residual and relu).  In JAX a
    bf16 input takes row 6's call for every conv (row 5's is fp32 only).
    Bounds: bytes at 2-byte activations (4-byte [F] vectors) over 3.35
    TB/s, flops over the dense bf16 tensor peak.  Library calls in bf16 on
    channels-last tensors: F.conv2d + torch.var_mean; F.batch_norm + z,
    relu_.  Launches are the AMP conv-tier runs' counts (amp1 and keep
    together)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv_epilogue as ce

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cl = torch.channels_last
    rng = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = []
    for label, key in (("3x3/1 pad 1", (RESNET_BATCH, 56, 56, 64, 64, 3, 1,
                                        1)),
                       ("1x1/1", (RESNET_BATCH, 56, 56, 64, 256, 1, 1, 0)),
                       ("7x7/2 pad 3 stem", (RESNET_BATCH, 224, 224, 3, 64,
                                             7, 2, 3))):
        N, H, W, C, Fo, K, s, p = key
        x, w, _, _ = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        x, w = x.to(bf16), w.to(bf16)
        xn = x.permute(0, 3, 1, 2)  # NCHW-shaped, channels-last memory
        wn = w.permute(3, 2, 0, 1).contiguous(memory_format=cl)
        nbytes, flops = _conv_stats_work(N, H, W, C, Fo, K, s, p, itemsize=2)
        rows.append(_row(
            "conv_stats_bf16",
            "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "paddle_tpu/kernels/conv_epilogue.py:383",
            sum(v["conv_stats"] for v in launches.values()),
            conv_err["conv_stats"],
            device_ms(torch, lambda: ce.conv_stats(x, w, s, p)),
            device_ms(torch, lambda: ce.conv_stats_reference(x, w, s, p)),
            nbytes, flops,
            device_ms(torch, lambda: torch.var_mean(
                F.conv2d(xn, wn, stride=s, padding=p), dim=(0, 2, 3),
                unbiased=False)),
            {"row": "row 6 (bf16): " + label, "x": [N, H, W, C],
             "w": [K, K, C, Fo], "stride": s, "padding": p,
             "dtype": "bfloat16",
             "library_call": "F.conv2d (bf16, channels-last) + "
                             "torch.var_mean"}, BF16_FLOPS_PER_S))
        del x, w, xn, wn
    N, H, W, Fo = RESNET_BATCH, 56, 56, 256
    out = torch.randn(N, H, W, Fo, generator=rng, device=dev).to(bf16)
    z = torch.randn(N, H, W, Fo, generator=rng, device=dev).to(bf16)
    var, mean = torch.var_mean(out.float(), dim=(0, 1, 2), unbiased=False)
    inv = torch.rsqrt(var + 1e-5)
    gamma = torch.rand(Fo, generator=rng, device=dev) + 0.5
    beta = torch.randn(Fo, generator=rng, device=dev)
    on, zn = out.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2)
    epi = _row(
        "bn_epilogue_bf16", "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
        "paddle_tpu/kernels/conv_epilogue.py:412",
        sum(v["bn_epilogue"] for v in launches.values()),
        conv_err["bn_epilogue"],
        device_ms(torch, lambda: ce.bn_epilogue(out, mean, inv, gamma, beta,
                                                z, "relu")),
        device_ms(torch, lambda: ce.bn_epilogue_reference(
            out, mean, inv, gamma, beta, z, "relu")),
        2 * 3 * out.numel() + 4 * 4 * Fo, 6 * out.numel(),
        device_ms(torch, lambda: torch.relu_(F.batch_norm(
            on, mean, var, gamma, beta, False, 0.0, 1e-5) + zn)),
        {"row": "row 7 (bf16)", "out": [N, H, W, Fo], "residual": True,
         "act": "relu", "dtype": "bfloat16",
         "library_call": "F.batch_norm(bf16, training=False) + z, relu_"},
        BF16_FLOPS_PER_S)
    emit({"phase": "conv_timing_bf16", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "launches_counted_over": f"{RESNET_STEPS} steps of the conv tier "
          "under amp1 and under keep",
          "rows": [{k: r[k] for k in ("name", "replaces", "launches", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape")}
                   for r in rows + [epi]]})
    first = dict(rows[0])
    first["rows"] = [{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")}
                     for r in rows]
    for r in (first, epi):
        r.pop("shape")
        r["launches_by_path"] = {
            "resnet_" + k: v["conv_stats" if r is first else "bn_epilogue"]
            for k, v in launches.items() if k.startswith("conv_")}
    return [first, epi]


# -- phase 6: timing -------------------------------------------------------

def device_ms(torch, fn, reps=30, warmup=5):
    """Median device time of fn() over `reps` calls, each bracketed by CUDA
    events, all queued behind a device sleep so the host's enqueue time
    never shows up as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def phase_timing(torch, np, reqs, parity_err, launches):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    H, D = CFG["n_head"], CFG["d_model"] // CFG["n_head"]
    scale = D ** -0.5
    kernels = []

    # flash_fwd at the first prefill group's shape: the first MAX_BATCH
    # prompts, padded to their longest
    lens = [len(r.prompt) for r in reqs[:MAX_BATCH]]
    B, S = len(lens), max(lens)
    q = torch.randn(B, H, S, D, generator=rng, device=dev)
    k = torch.randn(B, H, S, D, generator=rng, device=dev)
    v = torch.randn(B, H, S, D, generator=rng, device=dev)
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    mask = ((pos[None, :] < kl[:, None].long())[:, None, None, :]
            & (pos[None, :] <= pos[:, None])[None, None])
    pairs = sum(sum(min(n, i + 1) for i in range(S)) for n in lens) * H
    f_bytes = 4 * (2 * B * H * S * D + 2 * H * D * sum(lens)) + 4 * B
    f_flops = 4 * D * pairs
    kernels.append(_row(
        "flash_fwd", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        "paddle_tpu/kernels/flash_attention.py:317", launches["flash_fwd"],
        parity_err["flash_fwd"],
        device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True,
                                                    k_lengths=kl)),
        device_ms(torch, lambda: fa.reference_attention(q, k, v, True, scale,
                                                        k_lengths=kl)),
        f_bytes, f_flops,
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale)),
        {"B": B, "H": H, "S": S, "D": D, "k_lengths": lens}))

    # paged_decode at a mid-generation decode step of that group: each
    # sequence holds its prompt plus half the new tokens
    dlens = [n + MAX_NEW // 2 for n in lens]
    qd, kp, vp, tables, ln = _paged_case(torch, rng, B, H, H, D, PAGE_SIZE,
                                         dlens, dev)
    kg = pa.gather_kv_pages(kp, tables)
    vg = pa.gather_kv_pages(vp, tables)
    kmask = (torch.arange(kg.shape[2], device=dev)[None, :]
             < ln[:, None].long())[:, None, None, :]
    p_bytes = 4 * (2 * B * H * D + 2 * H * D * sum(dlens)) \
        + 4 * (tables.numel() + B)
    p_flops = 4 * D * H * sum(dlens)
    kernels.append(_row(
        "paged_decode", "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
        "paddle_tpu/kernels/paged_attention.py:645", launches["paged_decode"],
        parity_err["paged_decode"],
        device_ms(torch, lambda: pa.paged_decode_attention(qd, kp, vp,
                                                           tables, ln)),
        device_ms(torch, lambda: pa.paged_decode_reference(qd, kp, vp,
                                                           tables, ln)),
        p_bytes, p_flops,
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, kg, vg, attn_mask=kmask, scale=scale)),
        {"B": B, "H_q": H, "H_kv": H, "D": D, "page_size": PAGE_SIZE,
         "lengths": dlens}))
    emit({"phase": "timing", "method": "CUDA events, median of 30 after 5 "
          "warm-up calls, queued behind torch.cuda._sleep",
          "library_call": {"flash_fwd": "SDPA with a boolean causal+padding "
                           "mask", "paged_decode": "SDPA over K/V already "
                           "gathered from the pages (gather not timed)"},
          "shapes": {r["name"]: r.pop("shape") for r in kernels}})
    return kernels


def phase_spec_timing(torch, np, reqs, errs, launches):
    """verify_f32, decode_i8 and verify_i8 at the speculative serving shape
    (B = 8, H = H_kv = 8, D = 64, page 16, Sq = 5 with every block full),
    a mid-generation step of the first admitted group of the motif
    requests, on pages the pool's own write_kv filled.  Bound: live K/V
    read once at the pool's itemsize, plus the int8 scales of the live
    pages, q, o, tables and lengths, over 3.35 TB/s; against 4 * D fp32
    flops per visible (row, key) pair (plus one per dequantized element)
    over 67 TFLOP/s.  Library: SDPA over the gathered (dequantized) K/V
    with a boolean mask (gather not timed)."""
    import torch.nn.functional as F

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 6)
    H, D = CFG["n_head"], CFG["d_model"] // CFG["n_head"]
    scale = D ** -0.5
    lens = [len(r.prompt) + MAX_NEW // 2 for r in reqs[:MAX_BATCH]]
    B = len(lens)
    n_pages = sum(-(-n // PAGE_SIZE) for n in lens)
    rows = []
    for variant, dtype, sq in (("verify_f32", "float32", SPEC_D + 1),
                               ("decode_i8", "int8", 1),
                               ("verify_i8", "int8", SPEC_D + 1)):
        pool, tables, ln = _pool_layer(torch, serving, rng, H, H, D, lens,
                                       dtype, dev)
        kp, vp = pool.k_pages[0], pool.v_pages[0]
        ks, vs = pool.layer_scales(0)
        q = torch.randn(B, H, sq, D, generator=rng, device=dev)
        ql = (torch.full((B,), sq, dtype=torch.int32, device=dev)
              if sq > 1 else None)
        kg = pa.gather_kv_pages(kp, tables, ks)
        vg = pa.gather_kv_pages(vp, tables, vs)
        j = torch.arange(kg.shape[2], device=dev)
        pos_q = (ln.long() - sq)[:, None] + torch.arange(sq, device=dev)
        vis = ((j[None, None, :] <= pos_q[:, :, None])
               & (j[None, None, :] < ln.long()[:, None, None]))[:, None]
        if sq > 1:
            plain = lambda: pa.paged_verify_reference(  # noqa: E731
                q, kp, vp, tables, ln, ql, scale, ks, vs)
        else:
            plain = lambda: pa.paged_decode_reference(  # noqa: E731
                q, kp, vp, tables, ln, scale, ks, vs)
        itemsize = kp.element_size()
        nbytes = (itemsize * 2 * H * D * sum(lens) + 4 * 2 * B * H * sq * D
                  + 4 * (tables.numel() + 2 * B)
                  + (2 * 4 * n_pages if dtype == "int8" else 0))
        pairs = sum(n - sq + t + 1 for n in lens for t in range(sq))
        flops = 4 * D * H * pairs \
            + (2 * H * D * sum(lens) if dtype == "int8" else 0)
        path = "int8" if dtype == "int8" else "spec"
        rows.append(_row(
            "paged_" + variant,
            "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
            "paddle_tpu/kernels/paged_attention.py:645",
            launches[path][variant], errs[variant],
            device_ms(torch, lambda: pa.paged_decode_attention(
                q, kp, vp, tables, ln, q_lengths=ql, k_scales=ks,
                v_scales=vs)),
            device_ms(torch, plain), nbytes, flops,
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=vis, scale=scale)),
            {"B": B, "H_q": H, "H_kv": H, "D": D, "Sq": sq,
             "page_size": PAGE_SIZE, "pool": dtype, "lengths": lens}))
    emit({"phase": "spec_timing", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": "SDPA over K/V already gathered (and "
          "dequantized) from the pages, boolean mask (gather not timed)",
          "shapes": {r["name"]: r.pop("shape") for r in rows},
          "row_tiling": _row_tiling(torch, rng, lens)})
    return rows


def _row_tiling(torch, rng, lens):
    """What row tiles cost: at G = 8, D = 128 (H_q 16 over H_kv 2) a decode
    step is one tile of G * D = 1024 outputs and a verify step of Sq = 5
    is five, each re-streaming the sequence's pages.  Times both on the
    same fp32 pages, beside the KV bytes read once and once per tile."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    Hq, Hkv, D, sq = 16, 2, 128, SPEC_D + 1
    pool, tables, ln = _pool_layer(torch, serving, rng, Hq, Hkv, D, lens,
                                   "float32", dev)
    kp, vp = pool.k_pages[0], pool.v_pages[0]
    q = torch.randn(len(lens), Hq, sq, D, generator=rng, device=dev)
    q1 = q[:, :, :1].contiguous()
    ql = torch.full((len(lens),), sq, dtype=torch.int32, device=dev)
    kv_bytes = 4 * 2 * Hkv * D * sum(lens)
    tiles = -(-(Hq // Hkv) * sq * D // 1024)
    return {"H_q": Hq, "H_kv": Hkv, "D": D, "Sq": sq, "tiles": tiles,
            "decode_ms": device_ms(torch, lambda: pa.paged_decode_attention(
                q1, kp, vp, tables, ln)),
            "verify_ms": device_ms(torch, lambda: pa.paged_decode_attention(
                q, kp, vp, tables, ln, q_lengths=ql)),
            "kv_bytes_once": kv_bytes, "kv_bytes_read": tiles * kv_bytes,
            "kv_once_bound_ms": 1e3 * kv_bytes / HBM_BYTES_PER_S}


def phase_train_timing(torch, bwd_err, launches, cfg, batch, bf16=False):
    """The two backward kernels, and flash_fwd with its lse output, at the
    training shape of the decoder's causal self-attention: [B, H, S, D] =
    [TRAIN_BATCH, 8, 256, 64], k_lengths from the fixed batch's target
    rows; fp32, or with ``bf16`` the bf16 entries on bf16 tensors.  Bounds
    count each input read once (K and V rows up to each row's length, at
    the element size; lse, D and the lengths in 4 bytes) and each output
    written once, and the flops of the visible (query, key) pairs: 4*D
    forward, 6*D dq (S, dP, dQ), 8*D dkv (S, dP, dK, dV), over the fp32
    peak or, for bf16, the dense bf16 tensor peak.  The plain time of
    both backward rows is flash_attention_bwd_reference, which computes
    dQ, dK and dV together; so is the library call, SDPA's backward
    through a boolean mask (in the same dtype)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, H, S = TRAIN_BATCH, cfg.n_head, cfg.max_length
    D = cfg.d_model // H
    scale = D ** -0.5
    dtype = torch.bfloat16 if bf16 else torch.float32
    suffix, e = ("_bf16", 2) if bf16 else ("", 4)
    peak = BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S
    fwd_plain = (fa.flash_attention_fwd_bf16_reference if bf16
                 else fa.flash_attention_fwd_reference)
    lens = [int(n) for n in (batch["trg_word"] != cfg.pad_idx).sum(axis=1)]
    q, k, v, dout = (torch.randn(B, H, S, D, generator=rng,
                                 device=dev).to(dtype) for _ in range(4))
    kl = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    mask = ((pos[None, :] < kl[:, None].long())[:, None, None, :]
            & (pos[None, :] <= pos[:, None])[None, None])
    pairs = H * sum(sum(min(n, i + 1) for i in range(S)) for n in lens)
    full, kv_rows, rows = B * H * S * D, H * D * sum(lens), B * H * S
    out, lse = fa.flash_attention_fwd(q, k, v, True, scale, kl)
    dvec = (dout.float() * out.float()).sum(dim=-1)
    plain_bwd = device_ms(torch, lambda: fa.flash_attention_bwd_reference(
        q, k, v, kl, out, lse, dout, True, scale))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              scale=scale)
    sdpa_bwd = device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), dout, retain_graph=True))
    shape = {"B": B, "H": H, "S": S, "D": D, "causal": True,
             "k_lengths": lens}
    shape["dtype"] = str(dtype).removeprefix("torch.")
    rows_out = [
        _row("flash_bwd_dq" + suffix,
             "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:391",
             launches["flash_bwd_dq"], bwd_err["flash_bwd_dq"],
             device_ms(torch, lambda: fa.flash_bwd_dq(
                 q, k, v, dout, lse, dvec, kl, True, scale)),
             plain_bwd, e * (3 * full + 2 * kv_rows) + 4 * (2 * rows + B),
             6 * D * pairs, sdpa_bwd, shape, peak),
        _row("flash_bwd_dkv" + suffix,
             "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:409",
             launches["flash_bwd_dkv"], bwd_err["flash_bwd_dkv"],
             device_ms(torch, lambda: fa.flash_bwd_dkv(
                 q, k, v, dout, lse, dvec, kl, True, scale)),
             plain_bwd, e * (4 * full + 2 * kv_rows) + 4 * (2 * rows + B),
             8 * D * pairs, sdpa_bwd, shape, peak)]
    fwd = _row("flash_fwd" + suffix,
               "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
               "paddle_tpu/kernels/flash_attention.py:317",
               launches["flash_fwd"], bwd_err["flash_fwd"],
               device_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, True, scale, kl)),
               device_ms(torch, lambda: fwd_plain(q, k, v, True, scale, kl)),
               e * (2 * full + 2 * kv_rows) + 4 * (rows + B), 4 * D * pairs,
               device_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, scale=scale)), shape, peak)
    emit({"phase": "train_timing" + suffix,
          "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "shape": shape, "library_call": "SDPA with a boolean causal+"
          "padding mask (forward); its backward through autograd.grad, one "
          "time for dQ, dK and dV together (backward rows)",
          "plain_call": "flash_attention_bwd_reference, dQ, dK and dV "
          "together (backward rows)",
          "flash_fwd_with_lse": {k: fwd[k] for k in (
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
          "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}
                   for r in rows_out]})
    for r in rows_out + [fwd]:
        r.pop("shape")
    return fwd, rows_out


def _conv_stats_work(N, H, W, C, Fo, K, s, p, itemsize=4):
    """(bytes, flops) of conv_stats: x, w read and out written once at
    ``itemsize`` bytes an element, the fp32 sum and sumsq once; 2 flops per
    tap of every output, 3 per output for the sums."""
    Ho, Wo = (H + 2 * p - K) // s + 1, (W + 2 * p - K) // s + 1
    M = N * Ho * Wo
    return (itemsize * (N * H * W * C + K * K * C * Fo + M * Fo) + 4 * 2 * Fo,
            2 * M * K * K * C * Fo + 3 * M * Fo)


def _tpu_row(key):
    """The TPU kernel a conv_stats launch of shape key (N, H, W, C, F, K,
    stride, padding) replaces: stride-1 convs with K > 1 took the
    in-kernel halo kernel (row 5), the others the host-padded one (row 6)."""
    return 5 if key[6] == 1 and key[5] > 1 else 6


def phase_conv_timing(torch, conv_err, launches, by_shape, trace):
    """conv_stats at kernel row 5's shape (3x3/1 pad 1 [256, 56, 56, 64]
    -> 64) and row 6's (1x1/1 [256, 56, 56, 64] -> 256, the 7x7/2 pad 3
    stem [256, 224, 224, 3] -> 64); bn_epilogue at row 7's ([256, 56, 56,
    256] with the residual, relu).  Library calls: F.conv2d (cuDNN, TF32
    off) then torch.var_mean over its output; F.batch_norm with the batch
    statistics, + z, relu_.  Launches are the ResNet phase's counts: by
    TPU row, and at the timed shape."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv_epilogue as ce

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 5)
    by_row = {5: 0, 6: 0}
    for key, n in by_shape.items():
        by_row[_tpu_row(key)] += n
    conv_rows = [("row 5: 3x3/1 pad 1", (RESNET_BATCH, 56, 56, 64, 64, 3, 1,
                                          1)),
                 ("row 6: 1x1/1", (RESNET_BATCH, 56, 56, 64, 256, 1, 1, 0)),
                 ("row 6: 7x7/2 pad 3 stem", (RESNET_BATCH, 224, 224, 3, 64,
                                               7, 2, 3))]
    rows = []
    for label, key in conv_rows:
        N, H, W, C, Fo, K, s, p = key
        x, w, _, _ = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        nbytes, flops = _conv_stats_work(N, H, W, C, Fo, K, s, p)
        rows.append(_row(
            "conv_stats", "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
            "paddle_tpu/kernels/conv_epilogue.py:"
            + ("347" if _tpu_row(key) == 5 else "383"),
            by_row[_tpu_row(key)], conv_err["conv_stats"],
            device_ms(torch, lambda: ce.conv_stats(x, w, s, p)),
            device_ms(torch, lambda: ce.conv_stats_reference(x, w, s, p)),
            nbytes, flops,
            device_ms(torch, lambda: torch.var_mean(
                F.conv2d(xn, wn, stride=s, padding=p), dim=(0, 2, 3),
                unbiased=False)),
            {"row": label, "x": [N, H, W, C], "w": [K, K, C, Fo],
             "stride": s, "padding": p,
             "launches_at_this_shape": by_shape.get(key + ("float32",), 0),
             "library_call": "F.conv2d + torch.var_mean"}))
        del x, w, xn, wn
    N, H, W, Fo = RESNET_BATCH, 56, 56, 256
    out = torch.randn(N, H, W, Fo, generator=rng, device=dev)
    z = torch.randn(N, H, W, Fo, generator=rng, device=dev)
    var, mean = torch.var_mean(out, dim=(0, 1, 2), unbiased=False)
    inv = torch.rsqrt(var + 1e-5)
    gamma = torch.rand(Fo, generator=rng, device=dev) + 0.5
    beta = torch.randn(Fo, generator=rng, device=dev)
    on, zn = out.permute(0, 3, 1, 2), z.permute(0, 3, 1, 2)
    epi = _row(
        "bn_epilogue", "paddle_tpu_torch/kernels/csrc/conv_epilogue.cu",
        "paddle_tpu/kernels/conv_epilogue.py:412",
        launches["bn_epilogue"], conv_err["bn_epilogue"],
        device_ms(torch, lambda: ce.bn_epilogue(out, mean, inv, gamma, beta,
                                                z, "relu")),
        device_ms(torch, lambda: ce.bn_epilogue_reference(
            out, mean, inv, gamma, beta, z, "relu")),
        4 * (3 * out.numel() + 4 * Fo), 6 * out.numel(),
        device_ms(torch, lambda: torch.relu_(F.batch_norm(
            on, mean, var, gamma, beta, False, 0.0, 1e-5) + zn)),
        {"row": "row 7", "out": [N, H, W, Fo], "residual": True,
         "act": "relu",
         "library_call": "F.batch_norm(training=False) + z, relu_"})
    emit({"phase": "conv_timing", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": {"conv_stats": "F.conv2d (cuDNN, TF32 off) + "
                           "torch.var_mean over its output",
                           "bn_epilogue": "F.batch_norm(batch stats, "
                           "training=False) + z, relu_"},
          "plain_call": {"conv_stats": "conv_stats_reference",
                         "bn_epilogue": "bn_epilogue_reference"},
          "device_ms_per_step_in_the_profiled_step":
              trace["kernel_ms_per_step"],
          "launches_counted_over": f"{RESNET_STEPS} steps",
          "rows": [{k: r[k] for k in ("name", "replaces", "launches", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms", "shape")}
                   for r in rows + [epi]]})
    first = dict(rows[0])
    first["launches"] = launches["conv_stats"]
    first["replaces"] = ("paddle_tpu/kernels/conv_epilogue.py:347 and :383 "
                         "(rows 5 and 6)")
    first["rows"] = [{k: r[k] for k in ("replaces", "launches", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape")}
                     for r in rows]
    for r in (first, epi):
        r.pop("shape")
        r["launches_by_path"] = {"resnet_training": r["launches"]}
    return [first, epi]


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops,
         library_ms, shape, flops_per_s=FP32_FLOPS_PER_S):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / flops_per_s
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": shape}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as fluid  # (fails at once outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    phase_build()
    parity_err = phase_parity(torch)
    spec_err = phase_spec_parity(torch)
    lc_err = phase_longctx_parity(torch)
    bwd_err = phase_bwd_parity(torch)
    bf16_err = phase_bf16_parity(torch)
    conv_err = phase_conv_parity(torch, fluid)
    conv_bf16_err = phase_conv_parity_bf16(torch, fluid)
    serve_launches, reqs = phase_main_path(torch, np)
    spec_launches, spec_reqs = phase_spec_main_path(torch, np)
    lc_launches = phase_longctx(torch, np)
    train_launches, batch, cfg = phase_training(torch, np)
    torch.cuda.empty_cache()
    amp_launches, amp_batch, amp_cfg = phase_amp_training(torch, np)
    torch.cuda.empty_cache()
    conv_launches, by_shape, trace = phase_resnet(torch, np, fluid)
    torch.cuda.empty_cache()
    resnet_amp_launches = phase_resnet_amp(torch, np, fluid)
    kernels = phase_timing(torch, np, reqs, parity_err, serve_launches)
    kernels += phase_spec_timing(torch, np, spec_reqs, spec_err,
                                 spec_launches)
    lc_rows, lc_flat = phase_longctx_timing(torch, np, lc_err, lc_launches)
    kernels += lc_rows
    # the fp32 backward rows run in the fp32 phase and under amp1
    fp32_bwd_launches = {k: train_launches[k] + amp_launches["amp1"][k]
                         for k in FLASH_KERNELS}
    _, bwd_rows = phase_train_timing(torch, bwd_err, fp32_bwd_launches, cfg,
                                     batch)
    for r in bwd_rows:
        kernel = r["name"]
        r["launches_by_path"] = {"training": train_launches[kernel],
                                 "training_amp1": amp_launches["amp1"][kernel]}
    kernels += bwd_rows
    bf16_fwd, bf16_bwd = phase_train_timing(
        torch, bf16_err, amp_launches["keep"], amp_cfg, amp_batch, bf16=True)
    for r in [bf16_fwd] + bf16_bwd:
        r["launches_by_path"] = {"training_amp_keep": r["launches"]}
    kernels += [bf16_fwd] + bf16_bwd
    kernels += phase_conv_timing(torch, conv_err, conv_launches, by_shape,
                                 trace)
    kernels += phase_conv_timing_bf16(torch, conv_bf16_err,
                                      resnet_amp_launches)
    # flash_fwd runs on every path and paged_decode on both fp32 serving
    # paths: their launches are the counted runs' sums
    by_path = {"serving": serve_launches["flash_fwd"],
               "speculative_serving": spec_launches["spec"]["flash_fwd"],
               "int8_serving": spec_launches["int8"]["flash_fwd"],
               "long_context_serving": sum(
                   a["flash_fwd"] for a in lc_launches.values()),
               "training": train_launches["flash_fwd"],
               "training_amp1": amp_launches["amp1"]["flash_fwd"]}
    kernels[0]["launches"] = sum(by_path.values())
    kernels[0]["launches_by_path"] = by_path
    kernels[0]["max_abs_err"] = max(parity_err["flash_fwd"],
                                    bwd_err["flash_fwd"])
    by_path = {"serving": serve_launches["paged_decode"],
               "speculative_serving": spec_launches["spec"]["decode_f32"],
               "long_context_no_window":
                   lc_launches["no_window"]["by_variant"]["decode_f32"]}
    kernels[1]["launches"] = sum(by_path.values())
    kernels[1]["launches_by_path"] = by_path
    kernels[1]["at_long_context"] = lc_flat
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
