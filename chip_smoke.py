#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no final result line):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``paddle_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) with its seconds and ptxas report.
2. Kernel parity at the serving path's shapes: ``flash_fwd`` against
   ``reference_attention`` and ``paged_decode`` against
   ``paged_decode_reference``, fp32 with TF32 off, max abs error <= 1e-4.
3. The main path at the Transformer-base width (vocab 10000, d_model 512,
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
4. Times from CUDA events (median of 30 after warm-up, the launches queued
   behind a device sleep so host overhead stays out): each kernel, its
   plain version, its bound (bytes over 3.35 TB/s or fp32 flops over
   67 TFLOP/s, the larger) and one PyTorch library call for the same
   function (SDPA), plus the end-to-end generated tokens/s and the
   median prefill and decode step times.

Each phase prints one JSON line; the line before the last is the
``kernels`` summary and the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

PARITY_TOL = 1e-4      # fp32 kernel vs plain version, max abs error
MARGIN_TOL = 1e-3      # top-2 logit margin below which a greedy tie may flip
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
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


# -- phase 3 --------------------------------------------------------------

def make_requests(serving, np):
    rng = np.random.RandomState(SEED)
    lens = rng.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, size=N_REQUESTS)
    return [serving.DecodeRequest(
        prompt=rng.randint(1, CFG["vocab_size"], size=int(n)).tolist(),
        max_new_tokens=MAX_NEW) for n in lens]


def _plain_decoder_cls(serving):
    from paddle_tpu_torch.kernels.flash_attention import reference_attention
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_reference,
    )

    class PlainDecoder(serving.TransformerDecoder):
        """The serving decoder with the plain versions called by name."""

        def attend_prefill(self, q, k, v, lens):
            return reference_attention(q, k, v, True, self.cfg.head_dim ** -0.5,
                                       k_lengths=lens)

        def attend_decode(self, q, k_pages, v_pages, tables, lengths):
            return paged_decode_reference(q, k_pages, v_pages, tables,
                                          lengths, self.cfg.head_dim ** -0.5)

    return PlainDecoder


def _new_pool(serving, cfg, device=None):
    per_seq = -(-(PROMPT_RANGE[1] + MAX_NEW) // PAGE_SIZE)
    return serving.KVCachePool(
        num_pages=MAX_BATCH * per_seq + 4, page_size=PAGE_SIZE,
        num_layers=cfg.n_layer, num_heads=cfg.n_head, head_dim=cfg.head_dim,
        num_kv_heads=cfg.num_kv_heads, device=device)


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
    fa.flash_attention.launches = 0
    pa.paged_decode_attention.launches = 0
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


def _trace(torch, serving, model, cfg, reqs, unprofiled_wall):
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
                                          max_batch=MAX_BATCH)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    attention_us = sum(us for k, us in by_name.items()
                       if "flash_fwd" in k or "paged_decode" in k)
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / unprofiled_wall,
            "attention_share_of_busy": attention_us / 1e6 / busy_s,
            "device_ms_by_kernel": {k[:80]: us / 1e3 for k, us in top},
            "attention_ms": attention_us / 1e3}


# -- phase 4 --------------------------------------------------------------

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


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, flops,
         library_ms, shape):
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
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
    import paddle_tpu_torch  # noqa: F401  (fails at once outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    phase_build()
    parity_err = phase_parity(torch)
    launches, reqs = phase_main_path(torch, np)
    kernels = phase_timing(torch, np, reqs, parity_err, launches)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
