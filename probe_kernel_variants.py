#!/usr/bin/env python3
"""Probe of redesigned kernels on the card: the fp32 flash forward
(``flash_fwd_f32`` of paddle_tpu_torch/kernels/csrc/flash_fwd.cu), the
fp32 flash backward (``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32`` of
csrc/flash_bwd.cu) and ``corpus_scale_f32`` (csrc/corpus.cu).  Run from
the root of a checkout on a host with one CUDA card:

    python3 probe_kernel_variants.py [PART ...]

with no PART for every part, or any of ``mma_rate``, ``fwd_variants``,
``flash_variants``, ``corpus_variants``, ``corpus_balance`` and ``sass``.
It prints one JSON line per part:

1. ``mma_rate``: the tensor pipe's rate for ``mma.sync.m16n8k8`` with tf32
   operands (fp32 accumulators) and for ``m16n8k16`` with bf16 operands,
   from a kernel that issues nothing else (eight independent accumulators
   a warp, eight warps a block, four blocks an SM): TFLOP/s over the
   whole card.
2. ``flash_variants``: variants of the fp32 backward made by textual edits
   of the checked-out source (``FLASH_VARIANTS``: each edit must match
   once), built side by side with the build's own nvcc flags, each held
   to the fp32 gate (max abs error <= 1e-4 * max(1, max |plain|) against
   ``flash_attention_bwd_reference``, TF32 off) and timed in turns (the
   list forward, then backward) at bench's Transformer shape (B 32, H 8,
   S 256, D 64, the k_lengths of ``LENS``), causal and not; with each
   variant's ptxas registers and spills.
3. ``corpus_variants``: variants of csrc/corpus.cu (``CORPUS_VARIANTS``)
   the same way: bit-equal to ``x * 2`` and timed in turns over [2, 4096,
   4096] at ``tile_rows`` 8 and 14, beside ``x * 2``.
4. ``corpus_balance``: corpus_scale as built at tile_rows 8 against the
   balance of its walk: its own grid (66 blocks a matrix walking 7 or 8
   tiles), 64 blocks a matrix (8 tiles each), and [2, 4224, 4096] (8
   tiles for each of 66 blocks), beside x * 2.
5. ``sass``: the opcode counts of each fp32 instantiation of flash_bwd.cu
   and flash_fwd.cu as they stand (``cuobjdump -sass``), which name the
   tensor-core instruction and count the split's instructions.
6. ``fwd_variants``: variants of the fp32 forward (``FWD_VARIANTS``: the
   walked key tile and the blocks an SM, Q's split fragments kept in
   registers or read from shared memory, S's products in one accumulator
   or three, the walked tiles split once in shared memory or by each
   warp, exp2f or the bare ex2.approx, and the planted fault of two TF32
   products a multiply), built and held to the fp32 gate as in part 2
   (out and lse against ``flash_attention_fwd_reference``; the fault must
   fail it), and timed in turns at bench's shape causal and not (with
   lse), at serving's first prefill shape (B 8, S 128, causal, no lse)
   and at S 2048 (B 4, causal, with lse); with ``--baseline FILE``,
   beside the fp32 entry of another flash_fwd.cu (an earlier commit's,
   unpacked with git archive).

Nothing here is imported by the port or by ``chip_smoke.py``.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "paddle_tpu_torch" / "kernels" / "csrc"
OUT = ROOT / "paddle_tpu_torch" / "kernels" / "build" / "probe"
LENS = [152, 212, 215, 175, 133, 181, 194, 240, 219, 203, 204, 239, 247,
        249, 141, 154, 171, 166, 146, 188, 138, 154, 213, 176, 183, 214,
        201, 140, 219, 131, 205, 186]
TOL = 1e-4

CFG64 = "  static constexpr int DKV_SUB = 32, BLOCKS = 2;"
WALK = "constexpr int F32_WALK = 32;"


def cfg64(dkv_sub, blocks):
    """An edit of the head-dim-64 shapes (F32Cfg<64>)."""
    return (CFG64, f"  static constexpr int DKV_SUB = {dkv_sub}, "
            f"BLOCKS = {blocks};")


# name -> [(old, new), ...] edits of csrc/flash_bwd.cu
FLASH_VARIANTS = {
    "as_built": [],
    # the split by cvt.rna.tf32.f32 in place of the integer rounding (the
    # same values for finite inputs)
    "split_cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                   "  unsigned r;\n"
                   '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
                   "  return r;")],
    # the blocks in the order of the bf16 kernels' (tiles, B * H) grid: a
    # batch row's tiles together, dq's first query tile (the lightest under
    # a causal mask) first
    "tile_major_grid": [
        ("  const int bh = blockIdx.x;\n  const int b = bh / H;\n"
         "  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;",
         "  const int bh = blockIdx.y;\n  const int b = bh / H;\n"
         "  const int q0 = blockIdx.x * BQ;"),
        ("  const int bh = blockIdx.x;\n  const int b = bh / H;\n"
         "  const int k0 = blockIdx.y * BK;",
         "  const int bh = blockIdx.y;\n  const int b = bh / H;\n"
         "  const int k0 = blockIdx.x * BK;"),
        ("dim3(B * H, (Sq + BQ - 1) / BQ)", "dim3((Sq + BQ - 1) / BQ, B * H)"),
        ("dim3(B * H, (Sk + BK - 1) / BK)", "dim3((Sk + BK - 1) / BK, B * H)")],
    # 64-row walked tiles (174,080 bytes of shared memory for dq at head
    # dim 64: one block an SM)
    "walk64": [(WALK, "constexpr int F32_WALK = 64;"), cfg64(32, 1)],
    # 16 queries a dkv sub-block
    "dkv_sub16": [cfg64(16, 2)],
}

FWD64 = ("struct FwdCfg<64> {\n  static constexpr int WALK = 16, BLOCKS = 3;\n"
         "  static constexpr bool Q_REGS = true;")


def fwd64(walk, blocks, q_regs):
    """An edit of the fp32 forward's head-dim-64 shapes (FwdCfg<64>)."""
    return (FWD64, f"struct FwdCfg<64> {{\n  static constexpr int WALK = "
            f"{walk}, BLOCKS = {blocks};\n  static constexpr bool Q_REGS = "
            f"{'true' if q_regs else 'false'};")


# name -> [(old, new), ...] edits of csrc/flash_fwd.cu; as built, head dim
# 64 walks 16-key tiles, three blocks an SM, Q's split fragments in
# registers
FWD_VARIANTS = {
    "as_built": [],
    # Q's split A fragments read from the split Q tile at each use
    "q_smem": [fwd64(16, 3, False)],
    # 32-key walked tiles, two blocks an SM (104,448 bytes of shared
    # memory each)
    "walk32_b2": [fwd64(32, 2, True)],
    # 64-key walked tiles: 174,080 bytes of shared memory, one block an SM
    "walk64_b1": [fwd64(64, 1, True)],
    # 8-key walked tiles, four blocks an SM (at most 128 registers)
    "walk8_b4": [fwd64(8, 4, False)],
    # S's three products a multiply into one accumulator (mma3), a chain
    # three times as long, in place of three (mma3_apart)
    "s_one_acc": [
        ("        mma3_apart(s1[j], s2[j], s[j], qa, kf);",
         "        mma3(s[j], qa, kf);"),
        ("    for (int e = 0; e < 4; ++e) s[j][e] = (s1[j][e] + s2[j][e]) + "
         "s[j][e];\n", "    for (int e = 0; e < 4; ++e) ;\n")],
    # K and V tiles left raw in shared memory, each warp splitting the B
    # fragments it loads (the ring keeps its size)
    "split_per_warp": [
        ("    split_tile_f32<D, WK>(k_t, ks_t, tid);\n"
         "    split_tile_f32<D, WK>(v_t, vs_t, tid);\n", ""),
        ("        load_b(kf, k_t, ks_t, k_off + 8 * j * LD + kc * 8, 4);",
         "        load_b_split(kf, k_t, k_off + 8 * j * LD + kc * 8, 4);"),
        ("        load_b(vf, v_t, vs_t, v_off + 8 * j * LD + 8 * n, LD);",
         "        load_b_split(vf, v_t, v_off + 8 * j * LD + 8 * n, LD);"),
        ("// The three products of mma3, each into its own accumulator",
         "__device__ __forceinline__ void load_b_split(FragB& f, const "
         "float* x,\n    int off, int dr) {\n"
         "  split_tf32(x[off], f.big[0], f.small[0]);\n"
         "  split_tf32(x[off + dr], f.big[1], f.small[1]);\n}\n\n"
         "// The three products of mma3, each into its own accumulator")],
    # exp2 by exp2f (MUFU.EX2 with range fix-ups) in place of ex2_approx
    "exp2f": [("      corr[h] = ex2_approx((m[h] - m_new) * sc);",
               "      corr[h] = exp2f((m[h] - m_new) * sc);"),
              ("          s[j][e] = ex2_approx(fmaf(s[j][e], sc, "
               "-msc[e >> 1]));",
               "          s[j][e] = exp2f(fmaf(s[j][e], sc, -msc[e >> 1]));")],
    # the planted fault: two TF32 products a multiply (B's small part
    # dropped), which must fail the gate
    "two_products": [
        ("  mma_tf32_1688(c, a.small, b.big[0], b.big[1]);\n"
         "  mma_tf32_1688(c, a.big, b.small[0], b.small[1]);\n",
         "  mma_tf32_1688(c, a.small, b.big[0], b.big[1]);\n"),
        ("  mma_tf32_1688(c2, a.big, b.small[0], b.small[1]);\n", "")],
}
# variants that must fail the gate
FWD_FAULTS = ("two_products",)
SERVE_LENS = [128, 100, 77, 64, 33, 16, 120, 90]


def span_edit(text, start, end, new):
    """The edit that replaces text[start marker:end marker] by `new`."""
    i = text.index(start)
    return text[i:text.index(end, i)], new


# the walk of corpus_scale_stream_kernel with a slot a warp
WARP_SLOTS_WALK = r'''  // warp w owns slot w and the chunks w, w + SLOTS, ... of the walk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < warp && c.live(); ++i) c.next();
  const unsigned bar = bars + 8 * warp;
  float4* v = reinterpret_cast<float4*>(slots + (long long)warp * chunk);
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (c.live()) {
      mbar_expect_tx(bar, c.bytes());
      bulk_load(smem_u32(v), src + c.at(), c.bytes(), bar);
    }
  }
  __syncwarp();
  for (unsigned n = 0; c.live(); ++n) {
    mbar_wait(bar, n & 1);
    const unsigned n4 = c.bytes() / 16;
    for (unsigned i = lane; i < n4; i += 32) {
      const float4 a = v[i];
      v[i] = make_float4(2.f * a.x, 2.f * a.y, 2.f * a.z, 2.f * a.w);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    Walk nx = c;
    for (int i = 0; i < SLOTS && nx.live(); ++i) nx.next();
    if (lane == 0) {
      bulk_store(dst + c.at(), smem_u32(v), c.bytes());
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (nx.live()) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_expect_tx(bar, nx.bytes());
        bulk_load(smem_u32(v), src + nx.at(), nx.bytes(), bar);
      }
    }
    __syncwarp();
    c = nx;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

'''

# name -> edits of csrc/corpus.cu (an edit may be a function of the text)
CORPUS_VARIANTS = {
    "as_built": [],
    # chunks of 16-byte multiples after a 64-byte header
    "align16": [("constexpr long long ALIGN = 128;\n"
                 "constexpr long long HEADER = 128;",
                 "constexpr long long ALIGN = 16;\n"
                 "constexpr long long HEADER = 64;")],
    "slots4": [("constexpr int SLOTS = 8;", "constexpr int SLOTS = 4;")],
    "slots12": [("constexpr int SLOTS = 8;", "constexpr int SLOTS = 12;")],
    # each warp owns a slot and every eighth chunk: no block barrier, one
    # chunk in flight a warp
    "warp_slots": [lambda text: span_edit(
        text, "  Walk p = c;  // the loads' cursor, thread 0's",
        "__global__ void corpus_scale_elem_kernel", WARP_SLOTS_WALK)],
}
SCALE_SHAPE = (2, 4096, 4096)

MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) rate_tf32(float* out, int iters) {
  float c[8][4] = {};
  unsigned a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void __launch_bounds__(256) rate_bf16(float* out, int iters) {
  float c[8][4] = {};
  unsigned a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int rate(int which, float* out, int blocks, int iters) {
  if (which == 0) rate_tf32<<<blocks, 256>>>(out, iters);
  else rate_bf16<<<blocks, 256>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvcc_all(sources):
    """{name: (path of .so, ptxas log)}, one nvcc each, all at once."""
    from paddle_tpu_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        so = OUT / f"lib{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (so, log)
    return built


def inline_includes(text):
    """`text` with each #include "<header>" of csrc/ replaced by the
    header's text, so that an edit can reach it and the variant builds
    outside csrc/."""
    return re.sub(r'^#include "([^"]+)"\n',
                  lambda m: (CSRC / m.group(1)).read_text(), text,
                  flags=re.MULTILINE)


def variant_source(name, edits):
    """csrc/<name>.cu, its csrc/ headers inlined, with `edits` applied."""
    text = inline_includes((CSRC / f"{name}.cu").read_text())
    for edit in edits:
        old, new = edit(text) if callable(edit) else edit
        if text.count(old) != 1:
            raise AssertionError(f"edit matches {text.count(old)} times: "
                                 f"{old[:80]!r}")
        text = text.replace(old, new)
    return text


def ptxas_f32(log):
    """{kernel: 'registers, spills'} for the fp32 instantiations."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and "tf32" in name:
            short = re.search(r"(flash_\w+?_kernel)ILi(\d+)", name)
            key = f"{short.group(1)}<{short.group(2)}>"
            if "spill" in line:
                out.setdefault(key, []).append(line.strip())
            if "registers" in line:
                out.setdefault(key, []).append(line.strip().split(": ")[-1])
    return out


def sass_counts(so):
    """{kernel: {opcode: count}} of the fp32 instantiations."""
    from paddle_tpu_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            short = re.search(r"(flash_\w+?_kernel)ILi(\d+)", fn)
            name = (f"{short.group(1)}<{short.group(2)}>"
                    if short and "tf32" in fn else None)
            if name:
                counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if name and m:
            counts[name][m.group(1)] += 1
    return {k: dict(v.most_common(40)) for k, v in counts.items()}


def fwd_entry(so):
    """The fp32 forward entry of a built flash_fwd.cu."""
    fn = ctypes.CDLL(str(so)).flash_fwd_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def part_mma_rate(torch, cs, built):
    """1. The tensor pipe's rates."""
    lib = ctypes.CDLL(str(built["mma_rate"][0]))
    lib.rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 2048
    out = torch.empty(blocks * 256, device="cuda")
    rates = {}
    for which, name, flop in ((0, "tf32_m16n8k8", 2 * 16 * 8 * 8),
                              (1, "bf16_m16n8k16", 2 * 16 * 8 * 16)):
        ms = cs.device_ms(torch, lambda: lib.rate(which, out.data_ptr(),
                                                  blocks, iters))
        mmas = blocks * 8 * iters * 8
        rates[name] = {"ms": ms, "tflop_s": mmas * flop / ms / 1e9}
    emit({"part": "mma_rate", "card": cs.card_line(), "sms": sms,
          "rates": rates})
    return True


def part_fwd_variants(torch, cs, built, baseline):
    """6. The fp32 forward's variants (and a baseline source's), in
    turns."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    entries = {n: fwd_entry(built[f"f_{n}"][0]) for n in FWD_VARIANTS}
    rows = {n: {"ptxas": ptxas_f32(built[f"f_{n}"][1])}
            for n in FWD_VARIANTS}
    if baseline:
        entries["baseline"] = fwd_entry(built["f_baseline"][0])
        rows["baseline"] = {"source": str(baseline)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    stream = torch.cuda.current_stream().cuda_stream
    ok = True
    shapes = {"causal": (LENS, 256, True, True),
              "noncausal": (LENS, 256, False, True),
              "serving_no_lse": (SERVE_LENS, 128, True, False),
              "causal_2048": ([2048] * 4, 2048, True, True)}
    for tag, (lens, S, causal, with_lse) in shapes.items():
        B, H, D = len(lens), 8, 64
        q, k, v = (torch.randn(B, H, S, D, generator=g, device=dev)
                   for _ in range(3))
        kl = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                          scale, kl)
        out = torch.empty_like(q)
        lse = torch.empty(B, H, S, device=dev)

        def run(n):
            err = entries[n](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             kl.data_ptr(), out.data_ptr(),
                             lse.data_ptr() if with_lse else None, B, H, S,
                             S, D, scale, int(causal), stream)
            if err:
                raise RuntimeError(f"{n} {tag}: cudaError_t {err}")

        live = want_lse < 1e29
        for n in entries:
            run(n)
            torch.cuda.synchronize()
            errs = {"out": float((out - want).abs().max()) / max(
                1.0, float(want.abs().max()))}
            if with_lse:
                errs["lse"] = float((lse[live] - want_lse[live]).abs().max()
                                    ) / max(1.0, float(want_lse[live].abs()
                                                       .max()))
            passed = all(e <= TOL for e in errs.values())
            rows[n][f"{tag}_err_rel"] = errs
            rows[n][f"{tag}_ok"] = passed
            ok &= passed != (n in FWD_FAULTS)
        order = list(entries) + list(entries)[::-1]
        times = collections.defaultdict(list)
        for n in order:
            times[n].append(cs.device_ms(torch, lambda: run(n)))
        for n in entries:
            rows[n][f"{tag}_ms"] = times[n]
        del q, k, v, out, lse
    emit({"part": "fwd_variants", "card": cs.card_line(),
          "shapes": {t: {"B": len(x[0]), "H": 8, "S": x[1], "D": 64,
                         "causal": x[2], "lse": x[3], "k_lengths": x[0]}
                     for t, x in shapes.items()},
          "method": "CUDA events, median of 30 after 5 warm-up calls, "
          "each variant twice (list forward, then backward)",
          "rows": rows})
    return ok


def part_flash_variants(torch, cs, built):
    """2. The fp32 backward's variants, in turns."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    entries = {}
    for n in FLASH_VARIANTS:
        lib = ctypes.CDLL(str(built[f"v_{n}"][0]))
        pair = []
        for kernel, ptrs in (("flash_bwd_dq_f32", 8), ("flash_bwd_dkv_f32", 9)):
            fn = getattr(lib, kernel)
            fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            pair.append(fn)
        entries[n] = pair
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    B, H, S, D = len(LENS), 8, 256, 64
    q, k, v, do = (torch.randn(B, H, S, D, generator=g, device=dev)
                   for _ in range(4))
    kl = torch.tensor(LENS, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    rows = {n: {"ptxas": ptxas_f32(built[f"v_{n}"][1])} for n in FLASH_VARIANTS}
    for causal in (True, False):
        out_, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                     kl)
        dvec = (do * out_).sum(-1)
        want = fa.flash_attention_bwd_reference(q, k, v, kl, out_, lse, do,
                                                causal, scale)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))

        def run(n, which):
            f_dq, f_dkv = entries[n]
            if which == "dq":
                err = f_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                           kl.data_ptr(), dq.data_ptr(), B, H, S, S, D,
                           scale, int(causal), stream)
            else:
                err = f_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                            kl.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
                            H, S, S, D, scale, int(causal), stream)
            if err:
                raise RuntimeError(f"{n} {which}: cudaError_t {err}")

        tag = "causal" if causal else "noncausal"
        for n in FLASH_VARIANTS:
            run(n, "dq")
            run(n, "dkv")
            torch.cuda.synchronize()
            errs = {name: float((got - w).abs().max()) / max(
                1.0, float(w.abs().max()))
                for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                        want)}
            rows[n][f"{tag}_err_rel"] = errs
            rows[n][f"{tag}_ok"] = all(e <= TOL for e in errs.values())
        order = list(FLASH_VARIANTS) + list(FLASH_VARIANTS)[::-1]
        times = collections.defaultdict(list)
        for n in order:
            for which in ("dq", "dkv"):
                times[(n, which)].append(
                    cs.device_ms(torch, lambda: run(n, which)))
        for n in FLASH_VARIANTS:
            for which in ("dq", "dkv"):
                rows[n][f"{tag}_{which}_ms"] = times[(n, which)]
    emit({"part": "flash_variants", "card": cs.card_line(),
          "shape": {"B": B, "H": H, "S": S, "D": D, "k_lengths": LENS},
          "method": "CUDA events, median of 30 after 5 warm-up calls, "
          "each variant twice (list forward, then backward)",
          "rows": rows})
    return all(r["causal_ok"] and r["noncausal_ok"] for r in rows.values())


def scale_entry(so):
    fn = ctypes.CDLL(str(so)).corpus_scale_f32
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def part_corpus_variants(torch, cs, built):
    """3. corpus_scale's variants, in turns."""
    from paddle_tpu_torch.kernels import corpus as ck

    scale_fns = {n: scale_entry(built[f"c_{n}"][0]) for n in CORPUS_VARIANTS}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.randn(*SCALE_SHAPE, generator=g, device=dev)
    y = torch.empty_like(x)
    crow = {n: {} for n in CORPUS_VARIANTS}
    ok = True
    for tile in (8, 14):
        smem = ck.corpus_scale_smem_bytes(x.shape, x.dtype, tile)
        _, grid_y = ck.corpus_scale_grid(x.shape, tile, sms)

        def scale_run(n):
            err = scale_fns[n](x.data_ptr(), y.data_ptr(), SCALE_SHAPE[0],
                               SCALE_SHAPE[1], SCALE_SHAPE[2], tile, grid_y,
                               smem, stream)
            if err:
                raise RuntimeError(f"{n} tile_rows {tile}: cudaError_t {err}")

        for n in CORPUS_VARIANTS:
            y.zero_()
            scale_run(n)
            torch.cuda.synchronize()
            crow[n][f"tile_{tile}_bit_equal"] = bool(torch.equal(y, x * 2))
            ok &= crow[n][f"tile_{tile}_bit_equal"]
        times = collections.defaultdict(list)
        for n in list(CORPUS_VARIANTS) + list(CORPUS_VARIANTS)[::-1]:
            times[n].append(cs.device_ms(torch, lambda: scale_run(n)))
            times["x * 2"].append(cs.device_ms(torch, lambda: x * 2))
        for n in CORPUS_VARIANTS:
            crow[n][f"tile_{tile}_ms"] = times[n]
        crow.setdefault("x * 2", {})[f"tile_{tile}_ms"] = times["x * 2"]
    emit({"part": "corpus_variants", "card": cs.card_line(),
          "shape": list(SCALE_SHAPE), "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, each variant twice (list forward, then "
          "backward), x * 2 after each", "rows": crow})
    return ok


def part_corpus_balance(torch, cs, built):
    """4. corpus_scale as built against the balance of its walk: the grid
    of corpus_scale_grid (66 blocks a matrix, 7 or 8 tiles each at
    tile_rows 8), 64 blocks a matrix (8 tiles each), and 4224 rows (528
    tiles a matrix, 8 for each of the 66 blocks), each beside x * 2."""
    from paddle_tpu_torch.kernels import corpus as ck

    fn = scale_entry(built["c_as_built"][0])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    balance, ok = {}, True
    for name, rows_n, grid_y in (("grid_66", 4096, None),
                                 ("grid_64", 4096, 64),
                                 ("rows_4224_grid_66", 4224, None)):
        shape = (2, rows_n, 4096)
        xb = torch.randn(*shape, generator=g, device=dev)
        yb = torch.empty_like(xb)
        smem = ck.corpus_scale_smem_bytes(shape, xb.dtype, 8)
        gy = grid_y or ck.corpus_scale_grid(shape, 8, sms)[1]

        def bal_run():
            err = fn(xb.data_ptr(), yb.data_ptr(), 2, rows_n, 4096, 8, gy,
                     smem, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")

        bal_run()
        torch.cuda.synchronize()
        ok &= bool(torch.equal(yb, xb * 2))
        balance[name] = {"grid_y": gy, "ms": [
            cs.device_ms(torch, bal_run) for _ in range(2)],
            "x * 2 ms": cs.device_ms(torch, lambda: xb * 2)}
        del xb, yb
    emit({"part": "corpus_balance", "card": cs.card_line(),
          "tile_rows": 8, "rows": balance})
    return ok


def part_sass(torch, cs, built):
    """5. SASS of flash_bwd.cu and flash_fwd.cu as they stand."""
    emit({"part": "sass", "counts": {
        **sass_counts(built["v_as_built"][0]),
        **sass_counts(built["f_as_built"][0])}})
    return True


# part -> (its function, the prefixes of the sources it builds)
PARTS = {"mma_rate": (part_mma_rate, ("mma_rate",)),
         "fwd_variants": (part_fwd_variants, ("f_",)),
         "flash_variants": (part_flash_variants, ("v_",)),
         "corpus_variants": (part_corpus_variants, ("c_",)),
         "corpus_balance": (part_corpus_balance, ("c_as_built",)),
         "sass": (part_sass, ("v_as_built", "f_as_built"))}


def main(argv) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*", help="parts to run, of "
                    f"{', '.join(PARTS)} (default: all)")
    ap.add_argument("--baseline", type=Path,
                    help="another flash_fwd.cu whose fp32 entry "
                    "fwd_variants times beside the variants")
    args = ap.parse_args(argv)
    parts = args.parts or list(PARTS)
    unknown = [p for p in parts if p not in PARTS]
    if unknown:
        ap.error(f"unknown parts {unknown}")
    if not torch.cuda.is_available():
        print("probe_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    sources = {f"v_{n}": variant_source("flash_bwd", e)
               for n, e in FLASH_VARIANTS.items()}
    sources.update({f"f_{n}": variant_source("flash_fwd", e)
                    for n, e in FWD_VARIANTS.items()})
    sources.update({f"c_{n}": variant_source("corpus", e)
                    for n, e in CORPUS_VARIANTS.items()})
    sources["mma_rate"] = MMA_RATE_SRC
    if args.baseline:
        sources["f_baseline"] = inline_includes(args.baseline.read_text())
    wanted = tuple(p for part in parts for p in PARTS[part][1])
    built = nvcc_all({n: t for n, t in sources.items()
                      if n.startswith(wanted)})
    ok = True
    for part in parts:
        fn = PARTS[part][0]
        ok &= (fn(torch, cs, built, args.baseline)
               if part == "fwd_variants" else fn(torch, cs, built))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
