#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (paddle_tpu_torch).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and
prints no final result line):

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``paddle_tpu_torch/kernels/csrc`` (one ``nvcc``
   per source, all started together) with its seconds and ptxas report
   (each kernel instantiation's name, spills and registers); a kernel of
   flash_fwd.cu, flash_bwd.cu or corpus.cu that spills fails the phase
   (the others' spills are listed).
2. Kernel parity, fp32 with TF32 off: ``flash_fwd`` against
   ``reference_attention`` and ``paged_decode`` against
   ``paged_decode_reference`` at the serving path's shapes (max abs error
   <= 1e-4); then flash_fwd's lse output, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` against ``flash_attention_fwd_reference`` /
   ``flash_attention_bwd_reference`` at the training shape and the edges
   (head_dim 64 and 128, causal and not, ragged lengths with a 0 row, S
   off the tile, Sk > Sq), max abs error <= 1e-4 * max(1, max |plain|);
   the largest relative lse error on rows with |lse| < 1 is reported;
   the fp32 forward (with lse) and each backward entry launched again on
   the same inputs give bit-equal outputs, and at the training shape the
   planted faults, on the same inputs, must fail that gate: the backward
   with one TF32 product a multiply on dQ, dK and dV, and the forward with
   two (the fp32 kernels split every operand for three) on out.
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
   their bf16 plain versions (the forward's over the TPU kernel's 128-key
   tile) on the training shape and the same edges: each output within
   2^-7 * max |plain| with at most 1% of its elements not bit-equal, lse
   within 1e-5 relative; planted faults (P, or dS, dS^T and P^T, left
   unrounded before their products; dS built from the bf16-rounded P, on
   dQ and dK; the forward's running max moved per 64 keys, required on
   the training shapes and the cached keys) must fail that gate; each
   bf16 entry launched twice on the same inputs gives bit-equal outputs;
   and the bf16 kernels against the fp32 kernels on the same values
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
   The bf16 entries of the paged kernel (``paged_decode_bf16``,
   ``paged_verify_bf16``, ``paged_walk_bf16``) against
   ``paged_bf16_reference`` on pages a bf16 pool's write_kv filled: flat,
   explicit starts + window + sinks over compacted tables, and two-level
   walks; Sq 1 and 5 (ragged q_lengths); G 1 and 2; pages of 16 and 24;
   B 8, H_q 8, D 64, at the serving lengths and at a 4080-token context:
   within 2^-7 * max |plain|, at most 1% of the elements not bit-equal;
   the three planted faults of the plain version (running max per 64-slot
   chunk, l from the rounded p, q unrounded) must each fail that gate in
   every case; and each bf16 launch against the fp32 entry on the same
   pages widened to fp32, within 2^-5 * max |fp32|.
   The paged kernel's cluster split at forced cluster sizes S in {1, 2,
   16} and at the wrapper's own S: fp32, int8 and bf16 pages at the
   4080-token lengths with a 0-length row and rows that end in rank 0's
   range, Sq 1 and 5, on flat tables, on unevicted tables whose windows
   hide whole ranks' ranges, on compacted tables and on two-level tables,
   each against its plain version under its gate (fp32 and int8: 1e-4 *
   max(1, max |plain|); bf16: the bf16 gate above); the flat launch
   against the starts walk and the two-level walk against the compacted
   starts walk reported (expected bit-equal); and a planted fault, the
   naive split (each rank's range from its own max, a plain model), that
   must fail the bf16 gate at S 2 and 16.
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
   time (torch.profiler) of the first three arms side by side.  Then the
   windowed arms (flat starts and two-level) once more over a bf16 pool,
   gated the same way against their bf16 plain runs, the bf16 walk
   launches counted, and the logit distance to the fp32 pool reported.
   Then shared-prefix serving at the Transformer-base width:
   tools/serve_bench.py's --prefix-share 0.75 traffic (32 requests, a
   96-token system prompt with 1-32 token tails, others 16-128 tokens;
   four of them extend an earlier prompt, so they attach its partly
   filled page and copy it), max_batch 8, prefill_chunk 64, four counted
   runs: bf16 pool + PrefixCache, fp32 pool + PrefixCache, bf16 without
   a cache, bf16 + PrefixCache with speculate=4.  Tokens and the prefix
   counters (hits, misses, cached tokens, prefill steps and tokens, the
   largest step's prefill tokens <= 64, copy-on-write copies, attached
   pages) equal the same run through the plain versions on the card;
   cow_copies >= 1 in a cached run; launches steps x n_layer of the pool
   dtype's decode / verify entries and none of any other; the pool empty
   after ``cache.clear()``.  Tokens/s, host-clock time to first token,
   prefill tokens, pages allocated and pool bytes a token per run, and a
   profiled run's busy share.
   Then sampled serving at the same width (``phase_sampled_serving``):
   the speculative traffic under tools/serve_bench.py's three sampling
   scenarios (temperature 0.8; with top_k 20; with top_p 0.9; request i
   seeded SEED + i, request 0 also with a logit bias, a stop sequence
   and max_new 16), beside the greedy arm of the same requests, at d = 0
   and speculate=4, over fp32 and int8 pools: launches = steps x n_layer
   of the pool dtype's entries and flash_fwd > 0, the pool clean, every
   sequence ended by its cap or by its stop sequence there and nowhere
   before, and each sampled run replayed bit for bit; a speculate=4 run
   whose drafter proposes the d = 0 run's sampled tokens (accepted and
   rolled-back tokens > 0); the card's sample_rows / spec_sample_rows
   against the CPU's on the recorded logits rows (and the loop's own
   tokens against the card's), equal outside the relative decision
   margin 1e-5 with at most 1% of the rows inside it, and the residual
   drawn unsalted on the card must fail that; the accept/resample
   epilogue's emitted distribution over 8192 fixed seeds (TV < 0.05
   against the plain epilogue, chi-square against the exact filtered
   softmax, acceptance within 5 sigma of p(draft)); tokens/s and step
   times of every run, and at the loop's shapes the epilogues' device
   ms and kernels a call (torch.profiler), the stream's, and a call's
   host ms.
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
   and a profiled step per tier (device time by kernel and by kind).
   Then, per tier, one batch-2 step with
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
   from ``class_batch`` (seed 0), with cuDNN deterministic (so that the
   losses, and the gate on them, read the same on every call).  Before
   it, conv-epilogue parity at
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
5a. The training paths through ``Executor.run_steps``, each step a
   replay of a captured CUDA graph (cuDNN deterministic): bench's
   Transformer under keep (dropout 0.1; bf16 flash kernels),
   Transformer-base in fp32 (fp32 flash kernels) and ResNet-50's conv
   tier under keep (conv_stats_bf16, bn_epilogue_bf16), at the widths,
   batches and optimizers above, two batches staged on the card once.
   From one startup state: two eager arms of ten ``run`` steps, and
   ``run_steps(steps=10)``, whose final persistables and last loss must
   lie no farther from the first eager arm's than the second eager arm
   does (bit-equal where that is 0); the counters over that call, zeroed
   just before it, must read ten times the eager step's launches in the
   path's dtype and none in the other, and a profiled replayed call of
   two steps (the second of two in one trace: the profiler drops records
   over ten steps, and of a trace's first replayed graph) must show twice
   them by kernel name; ``mode="flat"`` at two steps bit-equal to
   ``"scan"``.  Printed: eager and run_steps step medians (three timed
   calls), the busy share of a profiled eager step and of a profiled
   call, the warm-up and capture seconds, peak memory of both arms, and
   the bytes of every persistable and the profiled call's copies (the
   captured step ends by copying each new state into its buffer).  Then a
   program with ``assign_value`` through run_steps: its
   fetch equal to the CPU executor's.
5b. The program linter's kernel tier (``paddle_tpu_torch.analysis``) and
   the two corpus kernels (``csrc/corpus.cu``, kernel rows 8 and 9).
   ``corpus_add`` bit-equal to its plain version on [512, 128] + a [512]
   broadcast, [513, 128] (off the thread block) and [7, 129] (the scalar
   path); ``corpus_scale`` over [2, 4096, 4096] at tile_rows 8 (128 KiB a
   block) and 12 (192 KiB, a ragged last tile), and over [3, 1000, 1001]
   at tile_rows 7 (ragged tiles, the element path), bit-equal to x * 2.  ``corpus_smem_optin``
   must equal the linter's budget, 232448.  Then, the counters zeroed: both
   corpus programs captured (no launch) and linted, ``broadcast_lse``
   exactly broadcast-operand at 262144 bytes, ``vmem_overflow`` exactly
   shared-memory-overflow at 67108864 bytes; ``run_corpus_program(
   "broadcast_lse")`` and its captured graph bit-equal to the plain
   version; ``run_corpus_program("vmem_overflow")`` refused with
   ``KernelLaunchError`` carrying cudaErrorInvalidValue (asserted: the
   phase fails if that launch returns or raises anything else);
   tile_rows 14 (229376 bytes) clean and launched, bit-equal, tile_rows 15
   (245760) flagged and refused the same way; launches 2 corpus_add and 1
   corpus_scale.  Three controls must lint clean: the add with a
   full-size b, a 32 KiB broadcast, the scale at tile_rows 8.
5c. DeepFM training, as bench.py trains it (``deepfm(num_fields=26,
   vocab_size=1000000, embed_dim=10)``, hidden (400, 400, 400), batch
   512, ``AdamOptimizer(1e-3, lazy_mode=True)``, fp32): the two tables'
   gradients are SelectedRowsValues and lazy Adam updates only the rows
   the batch names.  No hand-written kernel is on this path.  From one
   startup state and one batch (seed 0) staged on the card: two eager
   arms of ten ``run`` steps, then ``run_steps(steps=10)``.  Gates, each
   printed on a line of its own when it fails: losses finite and the last
   below the first; the two arms bit-equal (losses and persistables);
   the replay bit-equal to the first arm (persistables and last loss);
   every table row no id touched bit-equal to its initial value, in the
   parameter and both moments, after the eager arm and after the replay;
   one step on the card against one on a ``CPUPlace`` executor from the
   same state: the loss within 1e-4 relative, and what the step changed
   in each persistable (the tables and their moments at the touched
   rows) within 2e-3 of the largest change the CPU step made to it.
   Four faults must fail that gate: three planted in the card step's
   state (the embedding table's rows left as they were, moved the wrong
   way, its moments those of a 1% larger gradient) and the card step
   run again with TF32 on.  Printed: eager step median and run_steps step
   (three timed calls over ten steps), examples/s, the busy share of a
   profiled eager step and of a profiled ten-step call with device time
   by kind, peak memory of both arms, the warm-up and capture seconds,
   and the bytes of every persistable.
6. Times from CUDA events (median of 30 after warm-up, the launches queued
   behind a device sleep so host overhead stays out): each kernel, its
   plain version, its bound (bytes over 3.35 TB/s or fp32 flops over 67
   TFLOP/s, the larger; the fp32 flash kernels' flops as three TF32
   products over 494.7 TFLOP/s, the FMA bound beside it) and one PyTorch
   library call for the same function (SDPA, forward or backward; cuDNN's
   conv2d plus var_mean; the batch_norm + add + relu chain); the verify and
   int8 variants of the paged kernel at the speculative serving shape (SDPA
   over the gathered, dequantized K/V); the backward kernels and flash_fwd
   with lse at the training shape; conv_stats at the shapes of kernel rows
   5 and 6, bn_epilogue at row 7's; rows 4d and 4e at the long-context
   decode shape after eviction (B 8, H 8, D 64, 34 live pages of a
   4080-token context; SDPA with a boolean mask over the gathered K/V) and
   row 4a over the same context unevicted; the bf16 entries of rows 1-3 at
   the training shape (bound over the dense bf16 tensor peak, 989 TFLOP/s;
   SDPA in bf16); the fp32 backward's bound as three TF32 products a
   multiply over the dense TF32 peak, 494.7 TFLOP/s, with the FMA bound
   beside it, and the fp32 pair again at the encoder's non-causal shape
   (k_lengths from the batch's source rows) beside SDPA's backward, the
   fp32 forward with lse there beside SDPA's forward; the bf16 entries of
   conv_stats (row 6: in JAX every bf16 conv takes it) at rows 5 and 6's
   shapes and bn_epilogue at row 7's, bytes at 2-byte activations, flops
   over the bf16 peak, the library calls in bf16 on channels-last tensors;
   the bf16 entries of rows 4a (serving shape and a 4080-token context), 4b
   (Sq 5), 4d and 4e (34 live pages) at the fp32 rows' shapes, bytes at
   2-byte pages, SDPA in bf16; rows 8 and 9 at the corpus shapes
   (corpus_add on [512, 128], library calls x + lse[:, None] and x + b on
   the materialised b; corpus_scale
   over [2, 4096, 4096] at tile_rows 8 and 14, library call x * 2), bounds
   from bytes; row 8 beside an empty kernel on its grid, launched and timed
   the same way (its launch floor), and again at [524288, 128], where its
   bytes lead.  ``flash_fwd_sweep``: the bf16 forward with lse, then the
   fp32 one, and SDPA's forward in the same dtype (boolean mask and
   is_causal) at H 8, D 64, causal, B * S = 8192 and S 256 to 2048.
   ``flash_bwd_sweep``: the bf16 backward kernels, then the fp32 ones,
   and SDPA's backward in the same dtype (boolean mask and is_causal) at
   the same shapes.  Both sweeps print the card's name and power limit.

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
TF32_FLOPS_PER_S = 494.7e12  # dense tf32 tensor-core peak
# the fp32 flash kernels' products are three TF32 products a multiply
# (big·big, big·small, small·big of the split operands)
TF32_PASSES = 3
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

# sources whose kernels must build with no register spills (the others'
# spills are reported)
NO_SPILL_SOURCES = ("flash_fwd", "flash_bwd", "corpus")


def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    # ptxas names each kernel (mangled, template arguments included) and
    # then gives its spills and registers
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
             for name, r in report.items()}
    spills = {}  # source -> [(kernel, its spill line)] where it spills
    for name, lines in ptxas.items():
        kernel = None
        for ln in lines:
            if "entry function" in ln:
                kernel = ln.split("'")[1]
            elif ("spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln):
                spills.setdefault(name, []).append((kernel, ln))
    emit({"phase": "build", "seconds": seconds,
          "per_source_s": {n: r["seconds"] for n, r in report.items()},
          "ptxas": ptxas, "spills": spills})
    bad = {n: v for n, v in spills.items() if n in NO_SPILL_SOURCES}
    if bad:
        raise AssertionError(f"kernels that must not spill do: {bad}")


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


def _tf32(torch, x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, at 10 mantissa bits (on the int32 view)."""
    return ((x.contiguous().view(torch.int32) + 0x1000)
            & -0x2000).view(torch.float32)


def _one_tf32_pass_bwd(torch, fa, q, k, v, k_lengths, out, lse, dout,
                       causal, scale):
    """The fp32 backward with one TF32 product a multiply (each operand
    rounded to tf32 once, no small terms): the planted fault that the
    kernels' split products exist to avoid.  Otherwise
    flash_attention_bwd_reference's arithmetic, in plain PyTorch with
    TF32 off, so the tensor cores' own rounding does not enter."""
    def mm(a, b):
        return torch.matmul(_tf32(torch, a), _tf32(torch, b))

    s = mm(q, k.transpose(-1, -2)) * scale
    vis = fa._visible(q.shape[0], s.shape[-2], s.shape[-1], causal,
                      k_lengths, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dvec = (dout * out).sum(dim=-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - dvec) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q),
            mm(p.transpose(-1, -2), dout))


def _two_tf32_products_fwd(torch, fa, q, k, v, causal, scale, k_lengths):
    """(out, lse) of the fp32 forward with two TF32 products a multiply
    (the left operand split, the right one rounded to tf32 once: one
    small term dropped), the planted fault next to the kernel's three.
    Otherwise flash_attention_fwd_reference's arithmetic, in plain
    PyTorch with TF32 off."""
    def mm(a, b):
        big = _tf32(torch, a)
        bb = _tf32(torch, b)
        return torch.matmul(_tf32(torch, a - big), bb) + torch.matmul(big, bb)

    s = mm(q, k.transpose(-1, -2)) * scale
    vis = fa._visible(q.shape[0], s.shape[-2], s.shape[-1], causal,
                      k_lengths, q.device)
    s = s.masked_fill(~vis, fa.NEG_INF)
    dead = s.amax(dim=-1) <= fa.NEG_INF / 2
    p = torch.softmax(s, dim=-1).masked_fill(dead[..., None], 0.0)
    lse = torch.logsumexp(s, dim=-1).masked_fill(dead, -fa.NEG_INF)
    return mm(p, v), lse


# the BWD_CASES at the training shape, where the planted faults (one TF32
# pass in the backward, two products in the forward) must fail the gate
ONE_PASS_REQUIRED = ("train_causal", "train_noncausal")


def phase_bwd_parity(torch):
    """flash_fwd's lse output and the two backward kernels against their
    plain versions.  The bound is relative to the plain values' scale:
    max abs error <= PARITY_TOL * max(1, max |plain|).  A fully masked row
    must give lse = +1e30 exactly, and dQ = 0.  Each backward entry
    launched again on the same inputs must give bit-equal outputs, and at
    the training shape the planted fault, one TF32 product a multiply
    (_one_tf32_pass_bwd, on the same inputs), must fail the gate on dQ, dK
    and dV; the fp32 forward launched again must give bit-equal out and
    lse, and its planted fault, two TF32 products a multiply
    (_two_tf32_products_fwd), must fail the gate on out at the training
    shape.  The largest relative lse error on rows with |lse| < 1, where
    the tensor cores' order of the score sums shows most, is reported."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases, errs = [], {"flash_fwd": [], "flash_bwd_dq": [],
                       "flash_bwd_dkv": []}
    relaunch, one_pass, two_products, lse_rel = {}, [], [], {}

    def gate(got, want):
        err = float((got - want).abs().max())
        return err, PARITY_TOL * max(1.0, float(want.abs().max()))

    def record(kernel, name, got, want):
        err, bound = gate(got, want)
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
        near0 = live & (want_lse.abs() < 1)
        lse_rel[name] = {"rows": int(near0.sum()), "max_rel_err": float(
            ((lse - want_lse).abs() / want_lse.abs())[near0].max())
            if bool(near0.any()) else None}
        out2, lse2 = fa.flash_attention_fwd(q, k, v, causal, scale, kl)
        record("flash_bwd_dq", name, dq, want[0])
        record("flash_bwd_dkv", name + "/dk", dk, want[1])
        record("flash_bwd_dkv", name + "/dv", dv, want[2])
        dvec = (dout.float() * out.float()).sum(dim=-1)
        dq2 = fa.flash_bwd_dq(q, k, v, dout, lse, dvec, kl, causal, scale)
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, dout, lse, dvec, kl, causal,
                                    scale)
        relaunch[name] = [bool(torch.equal(a, b)) for a, b in
                          ((out, out2), (lse, lse2), (dq, dq2), (dk, dk2),
                           (dv, dv2))]
        if name in ONE_PASS_REQUIRED:
            fault = _one_tf32_pass_bwd(torch, fa, q, k, v, kl, want_out,
                                       want_lse, dout, causal, scale)
            for grad, got, w in zip(("dq", "dk", "dv"), fault, want):
                err, bound = gate(got, w)
                one_pass.append({"case": name, "grad": grad,
                                 "max_abs_err": err, "bound": bound})
            f_out, f_lse = _two_tf32_products_fwd(torch, fa, q, k, v,
                                                  causal, scale, kl)
            for what, got, w in (("out", f_out, want_out),
                                 ("lse", f_lse[live], want_lse[live])):
                err, bound = gate(got, w)
                two_products.append({"case": name, "output": what,
                                     "max_abs_err": err, "bound": bound})
        del out, lse, out2, lse2, dq, dk, dv, dq2, dk2, dv2
    emit({"phase": "bwd_parity", "tolerance": "max abs err <= "
          f"{PARITY_TOL} * max(1, max |plain|)", "cases": cases,
          "lse_near_0": lse_rel,
          "relaunch_bit_equal": relaunch,
          "relaunch_order": ["out", "lse", "dq", "dk", "dv"],
          "one_tf32_pass_fault": one_pass,
          "two_tf32_products_fwd_fault": two_products})
    bad = [c for c in cases if not c["max_abs_err"] <= c["bound"]]
    if bad:
        raise AssertionError(f"backward parity beyond its bound: {bad}")
    unequal = {n: r for n, r in relaunch.items() if not all(r)}
    if unequal:
        raise AssertionError(f"fp32 relaunch not bit-equal (out, lse, dq, "
                             f"dk, dv): {unequal}")
    passed = [f for f in one_pass if f["max_abs_err"] <= f["bound"]]
    if passed or not one_pass:
        raise AssertionError(f"one TF32 pass a product passed the gate: "
                             f"{passed}")
    passed = [f for f in two_products if f["output"] == "out"
              and f["max_abs_err"] <= f["bound"]]
    if passed or not two_products:
        raise AssertionError(f"the forward with two TF32 products a multiply "
                             f"passed the gate on out: {passed}")
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


def _rounded_p_bwd(torch, fa, q, k, v, k_lengths, out, lse, dout, causal,
                   scale):
    """The bf16 backward with dS built from the bf16-rounded P instead of
    the unrounded one (the shortcut the packed P^T fragment invites in
    dkv): a moved rounding point, which dQ and dK must show.  Otherwise
    flash_attention_bwd_reference's arithmetic."""
    bf16 = torch.bfloat16
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    vis = fa._visible(q.shape[0], s.shape[-2], s.shape[-1], causal,
                      k_lengths, q.device)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    pr = p.to(bf16).float()
    dvec = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = pr * (torch.matmul(dof, vf.transpose(-1, -2)) - dvec) * scale
    return (torch.matmul(ds.to(bf16).float(), kf).to(bf16),
            torch.matmul(ds.transpose(-1, -2).to(bf16).float(), qf).to(bf16),
            torch.matmul(pr.transpose(-1, -2), dof).to(bf16))


# the BWD_CASES where rows see enough keys on both sides of key 64 that a
# running max moved per 64 keys must fail the bf16 gate (the other cases'
# shares are reported)
TILE_64_REQUIRED = ("train_causal", "train_noncausal", "cached_keys")


def phase_bf16_parity(torch):
    """The bf16 entries of flash_fwd, flash_bwd_dq and flash_bwd_dkv
    against their bf16 plain versions (forward: the TPU kernel's 128-key
    tile, as the kernel), on BWD_CASES in bf16, the backward on the
    kernel's own out and lse.  Each output: max abs error <= BF16_ULP *
    max |plain| and at most MISMATCH_SHARE of its elements not bit-equal;
    lse within LSE_RTOL.  Planted faults must fail that gate: P
    unrounded before PV in the forward, and its running max moved per 64
    keys (``tile_64``: the plain version with block_k=64, required to
    fail on TILE_64_REQUIRED and reported on the others); dS / dS^T /
    P^T unrounded in the backward, and dS built from the bf16-rounded P
    (on dQ and dK).  Each bf16 entry, launched twice on the same inputs,
    must give bit-equal outputs (each output has one owner block, no
    atomics).
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
    cases, faults, vs_fp32, relaunch = [], [], [], []
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
        tile_64 = fa.flash_attention_fwd_bf16_reference(
            q, k, v, causal, scale, kl, block_k=64)[0]
        again = fa.flash_attention_fwd(q, k, v, causal, scale, kl)
        moved = _moved_bwd(fa, q, k, v, kl, out, lse, dout, causal, scale)
        rounded_p = _rounded_p_bwd(torch, fa, q, k, v, kl, out, lse, dout,
                                   causal, scale)
        dvec = (dout.float() * out.float()).sum(dim=-1)
        twice = [[fa.flash_bwd_dq(q, k, v, dout, lse, dvec, kl, causal,
                                  scale),
                  *fa.flash_bwd_dkv(q, k, v, dout, lse, dvec, kl, causal,
                                    scale)] for _ in range(2)]
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
        relaunch.append({"case": name, "bit_equal": {
            what: bool(torch.equal(a, b)) for what, a, b in zip(
                ("out", "lse", "dq", "dk", "dv"), [out, lse, *twice[0]],
                [*again, *twice[1]])}})
        rows = [("flash_fwd", "out", out, want_out,
                 {"unrounded": moved_out, "tile_64": tile_64})] + [
            (kernel, what, g, w, bad) for kernel, what, g, w, bad in zip(
                ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dkv"),
                ("dq", "dk", "dv"), grads, want,
                ({"unrounded": moved[0], "ds_from_rounded_p": rounded_p[0]},
                 {"unrounded": moved[1], "ds_from_rounded_p": rounded_p[1]},
                 {"unrounded": moved[2]}))]
        for kernel, what, got, plain, bads in rows:
            gate = _bf16_gate(got, plain)
            cases.append({"kernel": kernel + "_bf16", "case": name,
                          "what": what, **gate})
            errs[kernel].append(gate["max_abs_err"])
            for fault, bad in bads.items():
                planted = _bf16_gate(got, bad)
                faults.append({"kernel": kernel + "_bf16", "case": name,
                               "what": what, "fault": fault,
                               "mismatch_share": planted["mismatch_share"],
                               "max_abs_err": planted["max_abs_err"],
                               "caught": not planted["ok"],
                               "required": fault != "tile_64"
                               or name in TILE_64_REQUIRED})
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
          "relaunch_bit_equal": relaunch,
          "vs_fp32_kernels": vs_fp32,
          "vs_fp32_tolerance": (
              "out: |bf16 - fp32| <= 2^-8 * (P|V| + |out|) + 1e-5 * P|V| "
              f"elementwise; lse rel <= {LSE_RTOL}; grads: |bf16 - fp32| "
              f"<= {BF16_VS_FP32} * |fp32| in norm")})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"bf16 parity beyond its bound: {bad}")
    missed = [c for c in faults if c["required"] and not c["caught"]]
    if missed:
        raise AssertionError(f"a planted rounding fault passed the gate: "
                             f"{missed}")
    unequal = [c for c in relaunch if not all(c["bit_equal"].values())]
    if unequal:
        raise AssertionError(f"two launches of a bf16 entry on the same "
                             f"inputs differ: {unequal}")
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

    from torch import bfloat16

    from paddle_tpu_torch.kernels.flash_attention import reference_attention
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_bf16_reference,
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
            if k_pages.dtype == bfloat16:
                return paged_bf16_reference(
                    q, k_pages, v_pages, tables, lengths, None,
                    walk.get("page_starts"), walk.get("windows"),
                    walk.get("sinks"), self.cfg.head_dim ** -0.5)
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
            if k_pages.dtype == bfloat16:
                return paged_bf16_reference(
                    q, k_pages, v_pages, tables, lengths, q_lengths,
                    walk.get("page_starts"), walk.get("windows"),
                    walk.get("sinks"), self.cfg.head_dim ** -0.5)
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


def _trace(torch, serving, model, cfg, reqs, unprofiled_wall,
           prefix_dtype=None, **loop_kw):
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

    if prefix_dtype is None:
        pool = _new_pool(serving, cfg)
    else:  # the shared-prefix phase's pool, with a PrefixCache
        pool = _prefix_pool(serving, cfg, prefix_dtype)
        loop_kw["prefix_cache"] = serving.PrefixCache(pool)
    loop = serving.ContinuousBatchingLoop(model, cfg, pool,
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
    errs = {v: [] for v in ("verify_f32", "decode_i8", "verify_i8")}

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


# -- phase 3b': sampled serving ----------------------------------------------

# tools/serve_bench.py:474-480's sampling scenarios; request i of a
# scenario draws from seed SEED + i
SAMPLING_SCENARIOS = {"temp": dict(temperature=0.8),
                      "topk": dict(temperature=0.8, top_k=20),
                      "topp": dict(temperature=0.8, top_p=0.9)}
# request 0 of each scenario also carries a logit bias, a stop sequence
# (its biased token) and a per-request cap
EDGE_TOKEN = 7
EDGE = dict(logit_bias={EDGE_TOKEN: 4.0, 1: -4.0}, stop=((EDGE_TOKEN,),),
            max_new=MAX_NEW // 2)
SAMPLING_MARGIN = 1e-5  # relative decision margin under which a draw may flip
NEAR_SHARE = 0.01      # at most this share of the rows inside it
EXACT_SEEDS = 8192     # seeds of the TV / chi-square harness
EXACT_V = 32
SAMPLED_PATHS = {0: "sampled_serving", SPEC_D: "sampled_speculative_serving"}


def _sampled_requests(serving, base, scenario):
    """``base`` (make_spec_requests) under one sampling scenario."""
    return [serving.DecodeRequest(
        r.prompt, r.max_new_tokens, sampling=serving.SamplingParams(
            seed=SEED + i, **SAMPLING_SCENARIOS[scenario],
            **(EDGE if i == 0 else {})))
        for i, r in enumerate(base)]


def _check_sampled_run(np, cfg, pool, reqs, results, name):
    """The pool clean; every sequence finite and ended by its cap, or by
    its stop sequence at its last token and nowhere before."""
    from paddle_tpu_torch.serving import stop_hit

    report = pool.check_invariants()
    if not report["ok"] or pool.used_pages:
        raise AssertionError(f"{name}: pool not clean after the run: "
                             f"{report}")
    for req, r in zip(reqs, results):
        p = req.sampling
        cap = min(req.max_new_tokens, p.max_new or req.max_new_tokens) \
            if p is not None else req.max_new_tokens
        n = len(r.tokens)
        stops = [j + 1 for j in range(n) if stop_hit(r.tokens[:j + 1], p)]
        if r.error is not None or not 0 < n <= cap or any(
                j != n for j in stops) or (n < cap and stops != [n]):
            raise AssertionError(f"{name}: sequence {r.seq_id}: {n} tokens "
                                 f"(cap {cap}, stops at {stops}), error "
                                 f"{r.error}")
        if not all(np.isfinite(row).all() and row.shape == (cfg.vocab_size,)
                   for row in r.logits):
            raise AssertionError(f"{name}: sequence {r.seq_id}: bad logits")


def _gate_sampled_launches(cfg, loop, launches, dtype, name):
    """Launches equal steps x n_layer per variant of the pool's dtype,
    flash_fwd > 0, and nothing of any other variant."""
    sfx = "i8" if dtype == "int8" else "f32"
    want = {"flash_fwd": loop.prefill_steps * cfg.n_layer,
            "decode_" + sfx: (loop.decode_steps - loop.spec_steps)
            * cfg.n_layer,
            "verify_" + sfx: loop.spec_steps * cfg.n_layer}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    if got != want or not got["flash_fwd"] or others:
        raise AssertionError(f"{name}: launches {launches}, want {want}")


def _recorded_rows(np, serving, reqs, results):
    """Every emitted row of every request with its params and index g,
    biased as the loop biased it: (rows [n, V], params, steps, tokens)."""
    rows, ps, gs, toks = [], [], [], []
    for req, r in zip(reqs, results):
        for t, (row, tok) in enumerate(zip(r.logits, r.tokens)):
            rows.append(serving.apply_bias(row, req.sampling))
            ps.append(req.sampling)
            gs.append(t)
            toks.append(tok)
    return np.stack(rows).astype(np.float32), ps, gs, np.asarray(toks)


def _recorded_blocks(np, serving, reqs, results, sq):
    """Verify-shaped inputs from recorded rows: for each request, blocks
    of sq consecutive emitted rows from g = 0, sq, 2 sq, ..., drafting at
    position j the argmax of row j (the draft most likely accepted), the
    last draft of every other block replaced by the next token id (so
    rejections come early too)."""
    x, ps, gs, drafts = [], [], [], []
    for req, r in zip(reqs, results):
        for t in range(0, len(r.tokens) - sq + 1, sq):
            rows = np.stack([serving.apply_bias(row, req.sampling)
                             for row in r.logits[t:t + sq]])
            d = [int(row.argmax()) for row in rows[:-1]]
            if (t // sq) % 2:
                d[-1] = (d[-1] + 1) % CFG["vocab_size"]
            x.append(rows)
            ps.append(req.sampling)
            gs.append(t)
            drafts.append(d)
    return np.stack(x).astype(np.float32), ps, gs, drafts


def _outside_margin(np, got, want, margin):
    """Rows that differ with a margin above SAMPLING_MARGIN, and the
    count of rows inside it."""
    diff = np.asarray([not np.array_equal(g, w) for g, w in zip(got, want)])
    near = margin <= SAMPLING_MARGIN
    return np.flatnonzero(diff & ~near).tolist(), int(near.sum())


def _spec_outcome(acc, toks):
    """Each row's walk: its accepted count and the tokens it emits."""
    return [(int(a),) + tuple(int(t) for t in row[:int(a) + 1])
            for a, row in zip(acc, toks)]


def _sampled_card_vs_cpu(torch, np, sampling, plain_in, spec_in):
    """The card's epilogues against the CPU's on the same recorded rows,
    outside the decision margin (the CPU's); and the planted fault (the
    residual Gumbels drawn unsalted, on the card) that must fail it."""
    dev = torch.device("cuda")
    rows, ps, gs, loop_toks = plain_in
    card = sampling.sample_rows(torch.as_tensor(rows, device=dev), ps, gs)
    cpu = sampling.sample_rows(rows, ps, gs)
    margin = sampling.decision_margins(rows, ps, gs)
    bad, near = _outside_margin(np, card, cpu, margin)
    loop_bad, loop_near = _outside_margin(np, loop_toks, card, margin)
    x, sps, sgs, drafts = spec_in
    xt = torch.as_tensor(x, device=dev)
    card_s = _spec_outcome(*sampling.spec_sample_rows(xt, sps, sgs, drafts))
    cpu_s = _spec_outcome(*sampling.spec_sample_rows(x, sps, sgs, drafts))
    s_margin = sampling.decision_margins(x, sps, sgs, drafts)
    s_bad, s_near = _outside_margin(np, card_s, cpu_s, s_margin)
    real = sampling._salt
    sampling._salt = (lambda k, salt: k if salt == sampling.RESIDUAL_SALT
                      else real(k, salt))
    try:
        fault = _spec_outcome(*sampling.spec_sample_rows(xt, sps, sgs,
                                                         drafts))
    finally:
        sampling._salt = real
    f_bad, _ = _outside_margin(np, fault, cpu_s, s_margin)
    accepted = sum(o[0] for o in cpu_s)
    out = {"plain": {"rows": len(gs), "outside_margin": bad,
                     "near_ties": near,
                     "loop_tokens_outside_margin": loop_bad,
                     "loop_near_ties": loop_near},
           "spec": {"rows": len(sgs), "sq": x.shape[1],
                    "accepted_drafts": accepted,
                    "drafts": sum(len(d) for d in drafts),
                    "outside_margin": s_bad, "near_ties": s_near},
           "fault_residual_unsalted": {"outside_margin": len(f_bad)}}
    for what, b, n, total in (("plain", bad + loop_bad, max(near, loop_near),
                               len(gs)), ("spec", s_bad, s_near, len(sgs))):
        if b or n > NEAR_SHARE * total:
            raise AssertionError(f"sampled card vs CPU ({what}): {out}")
    if not f_bad:
        raise AssertionError(f"sampled card vs CPU: the planted fault "
                             f"passed: {out}")
    return out


def _exactness(torch, np, sampling, kw):
    """tests/test_torch_sampling.py's harness on the card: the first
    token the accept/resample walk emits against the plain epilogue (TV),
    the exact filtered softmax (chi-square) and p(draft) (acceptance),
    over EXACT_SEEDS fixed seeds on one fixed row."""
    dev = torch.device("cuda")
    V, B = EXACT_V, EXACT_SEEDS
    row = np.random.RandomState(SEED + 5).standard_normal(V).astype(
        np.float32)
    ps = [sampling.SamplingParams(seed=i, **kw) for i in range(B)]
    p0 = ps[0]
    x = sampling._filter_scaled(
        torch.as_tensor(row[None]), torch.tensor([p0.temperature]),
        torch.tensor([p0.top_k]), torch.tensor([p0.top_p]))[0].double()
    x = (x - x[torch.isfinite(x)].max()).numpy()
    e = np.where(np.isfinite(x), np.exp(x), 0.0)
    p_exact = e / e.sum()
    draft = int(np.argsort(p_exact)[-2])
    spec = torch.as_tensor(np.broadcast_to(row, (B, 2, V)).copy(),
                           device=dev)
    acc, toks = sampling.spec_sample_rows(spec, ps, [0] * B, [[draft]] * B)
    plain = sampling.sample_rows(spec[:, 0], ps, [0] * B)
    emitted, accepted = toks[:, 0], acc >= 1
    tv = 0.5 * float(np.abs(np.bincount(emitted, minlength=V)
                            - np.bincount(plain, minlength=V)).sum()) / B
    exp = p_exact * B
    keep = exp >= 5
    chi2 = float((((np.bincount(emitted, minlength=V) - exp) ** 2
                   / np.maximum(exp, 1e-9))[keep]).sum())
    dof = int(keep.sum()) - 1
    p_d = float(p_exact[draft])
    sigmas = abs(float(accepted.mean()) - p_d) / np.sqrt(p_d * (1 - p_d) / B)
    out = {"tv": tv, "chi2": chi2, "dof": dof,
           "chi2_bound": dof + 6 * np.sqrt(2 * dof),
           "accept_rate": float(accepted.mean()), "p_draft": p_d,
           "accept_sigmas": float(sigmas)}
    if not (0 < accepted.sum() < B and (emitted[accepted] == draft).all()
            and (emitted[~accepted] != draft).all() and tv < 0.05
            and chi2 < out["chi2_bound"] and sigmas < 5):
        raise AssertionError(f"sampled exactness {kw}: {out}")
    return out


EPILOGUE_REPS = 20


def _epilogue_timing(torch, np, sampling, rows, ps):
    """The epilogues at the loop's step shapes (B = MAX_BATCH rows of
    recorded logits; the verify shape's Sq = SPEC_D + 1), EPILOGUE_REPS
    calls each: a whole call's host ms (its host copies and syncs
    included: what a loop step pays), and, under torch.profiler, the
    device ms and kernels a call of the tensor work alone, and of the
    stream alone (the Gumbels of one draw).  Eager launches are too
    short and too many to time with events behind a device sleep: the
    host falls behind the queue."""
    from paddle_tpu_torch.serving import _threefry

    dev = torch.device("cuda")
    B, sq, V = MAX_BATCH, SPEC_D + 1, CFG["vocab_size"]
    x = torch.as_tensor(rows[:B * sq], device=dev)
    x2, x3 = x[:B].contiguous(), x.reshape(B, sq, V)
    ps = ps[:B]
    knobs = sampling._knobs(ps, dev)
    g = torch.arange(B, device=dev)
    drafts = torch.zeros(B, sq, dtype=torch.int64, device=dev)
    q = torch.full((B,), sq, dtype=torch.int64, device=dev)
    keys = sampling._key_g(knobs[3], g)
    keys3 = sampling._key_g(knobs[3][:, None], g[:, None]
                            + torch.arange(sq, device=dev))
    gs = list(range(B))
    host_drafts = [[0] * (sq - 1)] * B

    def host_ms(fn):
        fn()
        times = []
        for _ in range(EPILOGUE_REPS):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    def device(fn):
        fn()
        prof = _profiled(torch, lambda: [fn() for _ in range(EPILOGUE_REPS)],
                         marks={})
        return {"device_ms": 1e3 * prof["busy_s"] / EPILOGUE_REPS,
                "kernels": prof["device_records"] / EPILOGUE_REPS,
                "profiled_wall_ms": 1e3 * prof["wall_s"] / EPILOGUE_REPS}

    return {"sample_rows": {
                "shape": [B, V],
                "call_host_ms": host_ms(
                    lambda: sampling.sample_rows(x2, ps, gs)),
                "tensor_work": device(
                    lambda: sampling._draw(x2, knobs, g)),
                "stream": device(lambda: _threefry.gumbel(keys, V))},
            "spec_sample_rows": {
                "shape": [B, sq, V],
                "call_host_ms": host_ms(
                    lambda: sampling.spec_sample_rows(x3, ps, gs,
                                                      host_drafts)),
                "tensor_work": device(
                    lambda: sampling._spec_draw(x3, knobs, g, drafts, q)),
                "stream": device(lambda: _threefry.gumbel(keys3, V))}}


def phase_sampled_serving(torch, np):
    """Sampled serving at the Transformer-base width on the speculative
    traffic (make_spec_requests) under serve_bench's three scenarios,
    beside the greedy arm of the same requests, at d = 0 and speculate=4,
    over fp32 and int8 pools: every counted run's launches, replay,
    pool and stop/cap checks; an oracle-drafter run whose sampled drafts
    are both accepted and rejected; the card's epilogues against the
    CPU's on the recorded rows, with the planted salt fault; the TV /
    chi-square harness; the epilogues' times.  Returns the launches of
    the sampled runs by path."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving import sampling

    cfg = serving.DecodeConfig(**CFG)
    params = serving.init_decode_params(cfg, seed=SEED)
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    base = make_spec_requests(serving, np)
    arms = {"greedy": base}
    arms.update({s: _sampled_requests(serving, base, s)
                 for s in SAMPLING_SCENARIOS})
    for d in SAMPLED_PATHS:  # warm-up: the epilogues' first launches
        serving.ContinuousBatchingLoop(model, cfg, _new_pool(serving, cfg),
                                       max_batch=MAX_BATCH,
                                       speculate=d).run(arms["topk"])
    by_path = {p: {} for p in SAMPLED_PATHS.values()}
    runs, recorded = {}, {}
    for dtype in ("float32", "int8"):
        for d, path in SAMPLED_PATHS.items():
            for arm, reqs in arms.items():
                name = f"{arm}{POOL_SFX[dtype]}_d{d}"
                loop, pool, res, wall, launches = _counted_run(
                    torch, serving, model, cfg, reqs, dtype=dtype,
                    speculate=d)
                _check_sampled_run(np, cfg, pool, reqs, res, name)
                _gate_sampled_launches(cfg, loop, launches, dtype, name)
                n_tok = sum(len(r.tokens) for r in res)
                runs[name] = _spec_summary(loop, wall, n_tok)
                runs[name].update(
                    generated_tokens=n_tok, epilogue_calls=len(
                        loop.epilogue_s), epilogue_ms_median=(
                        1e3 * statistics.median(loop.epilogue_s)
                        if loop.epilogue_s else None))
                if arm == "greedy":
                    continue
                for k, v in launches.items():
                    by_path[path][k] = by_path[path].get(k, 0) + v
                rpool = _new_pool(serving, cfg, dtype=dtype)
                replay = serving.ContinuousBatchingLoop(
                    model, cfg, rpool, max_batch=MAX_BATCH,
                    speculate=d).run(reqs)
                _check_sampled_run(np, cfg, rpool, reqs, replay,
                                   name + "_replay")
                if [r.tokens for r in res] != [r.tokens for r in replay]:
                    raise AssertionError(f"{name}: the replay's tokens "
                                         "differ from the run's")
                edge = res[0]
                runs[name]["edge_request"] = {
                    "tokens": len(edge.tokens),
                    "ended_by": "stop" if sampling.stop_hit(
                        edge.tokens, reqs[0].sampling) else "max_new"}
                recorded[name] = (reqs, res)
    spec_runs = [runs[f"{s}{sfx}_d{SPEC_D}"] for s in SAMPLING_SCENARIOS
                 for sfx in ("_f32", "_i8")]
    if not sum(r["drafted_tokens"] for r in spec_runs):
        raise AssertionError("sampled speculation drafted nothing")

    # the oracle drafter over sampled rows: the d = 0 run's tokens
    oreqs, ores = recorded["topk_f32_d0"]
    loop_o, pool_o, res_o, wall_o, launches_o = _counted_run(
        torch, serving, model, cfg, oreqs, speculate=SPEC_D,
        drafter=OracleDrafter(oreqs, ores, cfg.vocab_size))
    _check_sampled_run(np, cfg, pool_o, oreqs, res_o, "sampled_oracle")
    _gate_sampled_launches(cfg, loop_o, launches_o, "float32",
                           "sampled_oracle")
    if not (loop_o.accepted_tokens and loop_o.rolled_back_tokens
            and launches_o["verify_f32"]):
        raise AssertionError(
            f"sampled oracle drafter: accepted {loop_o.accepted_tokens}, "
            f"rolled back {loop_o.rolled_back_tokens}, verify launches "
            f"{launches_o['verify_f32']}: each must be > 0")
    for k, v in launches_o.items():
        path = by_path["sampled_speculative_serving"]
        path[k] = path.get(k, 0) + v

    # card against CPU on the recorded rows, by scenario
    parity = {}
    for s in SAMPLING_SCENARIOS:
        plain_in = _recorded_rows(np, serving, *recorded[f"{s}_f32_d0"])
        spec_in = _recorded_blocks(np, serving,
                                   *recorded[f"{s}_f32_d{SPEC_D}"],
                                   SPEC_D + 1)
        parity[s] = _sampled_card_vs_cpu(torch, np, sampling, plain_in,
                                         spec_in)
    accepted = [v["spec"]["accepted_drafts"] for v in parity.values()]
    if not 0 < sum(accepted) < sum(v["spec"]["drafts"]
                                   for v in parity.values()):
        raise AssertionError(f"sampled card vs CPU: accepted drafts "
                             f"{accepted}: both arms must fire")
    exact = {s: _exactness(torch, np, sampling, kw)
             for s, kw in SAMPLING_SCENARIOS.items()}
    rows, ps, _, _ = _recorded_rows(np, serving, *recorded["topk_f32_d0"])
    timing = _epilogue_timing(torch, np, sampling, rows, ps)
    emit({"phase": "sampled_serving", "card": card_line(), "config": CFG,
          "scenarios": SAMPLING_SCENARIOS, "edge_request": {
              "logit_bias": EDGE["logit_bias"], "stop": EDGE["stop"],
              "max_new": EDGE["max_new"]},
          "max_batch": MAX_BATCH, "requests": N_REQUESTS,
          "max_new_tokens": MAX_NEW, "speculate": SPEC_D,
          "traffic": "motif-tiled (tools/serve_bench.py --speculate), "
                     "request i seeded SEED + i",
          "runs": runs, "replay": "bit-equal in every sampled run",
          "oracle_drafter": _spec_summary(loop_o, wall_o, sum(
              len(r.tokens) for r in res_o)),
          "card_vs_cpu": parity, "exactness": exact,
          "epilogue": timing, "launches_by_path": by_path})
    return by_path


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
             sinks=None, lengths=LC_PARITY_LENS, page_size=PAGE_SIZE):
    """One layer of a pool filled through write_kv at `lengths` (in two
    rounds, the second at twice the magnitude: an int8 page's content
    re-quantizes).  With windows, each windowed row's interior is evicted
    before its last SPEC_D + 1 tokens are appended, as the loop evicts
    before a step's appends.  Returns (pool, ids)."""
    tail = SPEC_D + 1
    pages = sum(-(-n // page_size) for n in lengths) + 4
    pool = serving.KVCachePool(pages, page_size, 1, Hq, D, num_kv_heads=Hkv,
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


# bf16 paged parity (kernel row 4 in bf16): lengths at the serving shape
# and at a 4080-token context, pages of 16 and 24 slots (24 does not divide
# the kernel's 256-slot ring stage), G 1 and 2 at D 64, B 8
BF16_PARITY_LENS = {"serving": [144, 33, 66, 18, 150, 99, 120, 47],
                    "ctx4080": [4080, 3001, 1500, 700, 530, 100, 17, 5]}
BF16_PARITY_PAGES = (16, 24)
BF16_PARITY_HEADS = ((8, 8), (8, 4))  # (H_q, H_kv)
BF16_TL_BLOCK = 4  # two-level blocks of 4 pages: several blocks a row
# bf16 entry against the fp32 entry on the same bf16-valued pages: the
# rounding of q, p and the output moves an output by about 2^-8 of the
# largest; bound 2^-5 * max |fp32|
BF16_VS_FP32_PAGED = 2.0 ** -5


def _rows_gate(got, want, rows):
    """_bf16_gate over the valid rows (t < q_lengths) only."""
    m = rows.expand_as(got)
    return _bf16_gate(got[m], want[m])


def phase_bf16_paged_parity(torch):
    """The bf16 entries of the paged kernel (decode_bf16, verify_bf16,
    walk_bf16) against paged_bf16_reference on pages the bf16 pool's
    write_kv filled: the flat walk, explicit starts with the window + sink
    mask over tables compacted by evict_interior, and two-level tables of
    4-page blocks; Sq 1 and 5 (ragged q_lengths); G 1 and 2; pages of 16
    and 24; at the serving lengths and at a 4080-token context; B 8, H_q
    8, D 64.  Gate (valid rows): within 2^-7 * max |plain|, at most 1% of
    the elements not bit-equal.  Each of the three planted faults of the
    plain version (paged_attention.BF16_FAULTS: max per 64-slot chunk, l
    from the rounded p, q unrounded) must fail that gate in every case.
    And each bf16 launch against the fp32 entry on the same pages widened
    to fp32: within BF16_VS_FP32_PAGED * max |fp32|."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 9)
    win, snk = _lc_windows(torch, dev)
    qlens = torch.tensor(LC_PARITY_QLENS, dtype=torch.int32, device=dev)
    D = 64
    cases, faults, vs_fp32 = [], [], []
    errs = {"decode_bf16": [], "verify_bf16": [], "starts": [],
            "two_level": []}

    def on_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    for lname, lengths in BF16_PARITY_LENS.items():
        B = len(lengths)
        for ps in BF16_PARITY_PAGES:
            for Hq, Hkv in BF16_PARITY_HEADS:
                full, ids = _lc_pool(torch, serving, rng, Hq, Hkv, D,
                                     "bfloat16", dev, lengths=lengths,
                                     page_size=ps)
                ev, _ = _lc_pool(torch, serving, rng, Hq, Hkv, D, "bfloat16",
                                 dev, win, snk, lengths=lengths,
                                 page_size=ps)
                t_f, ln_f = on_dev(*full.page_table_batch(ids))
                t_s, st, ln_s = on_dev(*ev.page_tables_with_starts(ids))
                tl, ln_tl = ev.two_level_tables(ids, BF16_TL_BLOCK)
                wk = {"windows": win, "sinks": snk}
                walks = [("flat", full, t_f, ln_f, {}),
                         ("starts", ev, t_s, ln_s, dict(wk, page_starts=st)),
                         ("two_level", ev, _two_level_on(torch, pa, tl, dev),
                          on_dev(ln_tl)[0], wk)]
                for sq in (1, SPEC_D + 1):
                    q = torch.randn(B, Hq, sq, D, generator=rng, device=dev)
                    ql = qlens if sq > 1 else None
                    rows = _valid_rows(torch, qlens, sq, dev)
                    for walk, pool, t, ln, kw in walks:
                        kp, vp = pool.k_pages[0], pool.v_pages[0]
                        got = pa.paged_decode_attention(q, kp, vp, t, ln,
                                                        q_lengths=ql, **kw)

                        def plain(fault=None):
                            return pa.paged_bf16_reference(
                                q, kp, vp, t, ln, ql, kw.get("page_starts"),
                                kw.get("windows"), kw.get("sinks"),
                                D ** -0.5, fault=fault)

                        name = f"{lname}_ps{ps}_G{Hq // Hkv}_sq{sq}_{walk}"
                        g = _rows_gate(got, plain(), rows)
                        cases.append(dict(case=name, **g))
                        key = (walk if walk != "flat" else
                               "verify_bf16" if sq > 1 else "decode_bf16")
                        errs[key].append(g["max_abs_err"])
                        for f in pa.BF16_FAULTS:
                            faults.append(dict(case=name, fault=f,
                                               **_rows_gate(got, plain(f),
                                                            rows)))
                        f32 = pa.paged_decode_attention(
                            q, kp.float(), vp.float(), t, ln, q_lengths=ql,
                            **kw)
                        m = rows.expand_as(got)
                        vs_fp32.append({
                            "case": name,
                            "max_abs_diff": float((got - f32)[m].abs().max()),
                            "bound": BF16_VS_FP32_PAGED
                            * float(f32[m].abs().max())})
                del full, ev
    emit({"phase": "bf16_paged_parity", "tolerance": f"max abs err <= "
          f"{BF16_ULP} * max |plain| and at most {MISMATCH_SHARE} of the "
          "elements not bit-equal, valid rows; each planted fault must "
          f"fail it; against fp32: <= {BF16_VS_FP32_PAGED} * max |fp32|",
          "lengths": BF16_PARITY_LENS, "q_lengths_at_sq5": LC_PARITY_QLENS,
          "windows": win.tolist(), "sinks": snk.tolist(),
          "max_mismatch_share": max(c["mismatch_share"] for c in cases),
          "max_err_over_bound": max(c["max_abs_err"] / c["bound"]
                                    for c in cases),
          "faults_min_share": {f: min(x["mismatch_share"] for x in faults
                                      if x["fault"] == f)
                               for f in pa.BF16_FAULTS},
          "faults_max_share": {f: max(x["mismatch_share"] for x in faults
                                      if x["fault"] == f)
                               for f in pa.BF16_FAULTS},
          "vs_fp32_max_diff_over_bound": max(
              c["max_abs_diff"] / c["bound"] for c in vs_fp32),
          "vs_fp32_max_diff_over_max": max(
              c["max_abs_diff"] / c["bound"] * BF16_VS_FP32_PAGED
              for c in vs_fp32),
          "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    caught = [c for c in faults if c["ok"]]
    far = [c for c in vs_fp32 if not c["max_abs_diff"] <= c["bound"]]
    if bad or caught or far:
        raise AssertionError(
            f"bf16 paged parity: {len(bad)} cases beyond the gate "
            f"{bad[:3]}; {len(caught)} planted faults passed it "
            f"{caught[:3]}; {len(far)} beyond the fp32 bound {far[:3]}")
    return {k: max(v) for k, v in errs.items()}


# the cluster split (kernel row 4, every entry): forced cluster sizes, the
# 4080-token lengths with the last row's length set to 0, and per dtype
# the (H_q, H_kv, D) configurations
CLUSTER_FORCED = (1, 2, 16)
CLUSTER_HEADS = {"float32": ((8, 8, 64), (8, 2, 128)), "int8": ((8, 8, 64),),
                 "bfloat16": ((8, 8, 64), (8, 4, 64))}
NAIVE_SPLIT_S = (2, 16)


def _naive_split(torch, pa, q, kp, vp, tables, lengths, q_lengths, S):
    """Plain model of the kernel's cluster split over a flat bf16 walk in
    which every rank's range starts from its own max instead of the
    prefix max handed in (the planted fault): ranks of ceil(n / S) whole
    pages, per-page running max from NEG_INF/2, w = bf16(p) * exp(m_k -
    M_end), l from the unrounded p, the ranks summed in order."""
    from paddle_tpu_torch.kernels.flash_attention import NEG_INF

    B, Hq, Sq, D = q.shape
    Hkv, _, ps, _ = kp.shape
    R = Hq // Hkv * Sq
    dev = q.device
    ln = lengths.long()
    ql = (torch.full((B,), Sq, device=dev) if q_lengths is None
          else q_lengths.long())
    slots = tables.shape[1] * ps
    j = torch.arange(slots, device=dev)
    dead = (j[None, :] >= ln[:, None])[:, None, :, None]
    k = pa.gather_kv_pages(kp, tables).float().masked_fill(dead, 0.0)
    v = pa.gather_kv_pages(vp, tables).float().masked_fill(dead, 0.0)
    qr = q.to(torch.bfloat16).float().reshape(B, Hkv, R, D)
    qpos = (ln - ql)[:, None] + (torch.arange(R, device=dev) % Sq)[None, :]
    vis = ((j[None, None, :] <= qpos[:, :, None])
           & (j[None, None, :] < ln[:, None, None]))
    s_all = (torch.matmul(qr, k.transpose(-1, -2)) * D ** -0.5).masked_fill(
        ~vis[:, None], NEG_INF)
    out = torch.zeros(B, Hkv, R, D, device=dev)
    for b in range(B):
        n = -(-int(ln[b]) // ps)
        if not n:
            continue
        ppr = -(-n // S)
        m_end = torch.maximum(s_all[b, :, :, :n * ps].amax(-1, keepdim=True),
                              torch.tensor(NEG_INF / 2, device=dev))
        acc = torch.zeros(Hkv, R, D, device=dev)
        l = torch.zeros(Hkv, R, 1, device=dev)
        for i in range(S):
            m = torch.full((Hkv, R, 1), NEG_INF / 2, device=dev)
            for e in range(i * ppr, min((i + 1) * ppr, n)):
                sl = slice(e * ps, (e + 1) * ps)
                sp = s_all[b, :, :, sl]
                m = torch.maximum(m, sp.amax(-1, keepdim=True))
                p = torch.exp(sp - m)
                ek = torch.exp(m - m_end)
                acc += torch.matmul(p.to(torch.bfloat16).float() * ek,
                                    v[b, :, sl])
                l += (p * ek).sum(-1, keepdim=True)
        out[b] = acc / l.clamp_min(1e-30)
    return out.to(torch.bfloat16).float().reshape(B, Hq, Sq, D)


def phase_cluster_parity(torch):
    """The paged kernel's cluster split at forced cluster sizes S in
    CLUSTER_FORCED and at the wrapper's own, for fp32, int8 and bf16
    pages at the 4080-token lengths (the last row's length 0; rows of 17
    and 5 tokens end in rank 0's range), Sq 1 and 5, on four walks: flat
    tables; unevicted tables with explicit starts and the window + sink
    mask (a window of 64 or 1 without sinks hides whole ranks' ranges);
    tables compacted by evict_interior; two-level tables of 16-page
    blocks.  Gate on the valid rows: fp32 and int8 within PARITY_TOL *
    max(1, max |plain|) of paged_windowed_reference, bf16 the bf16 gate
    against paged_bf16_reference.  Reported: the flat launch against the
    unwindowed starts walk and the two-level against the compacted starts
    walk, at each S (expected bit-equal).  Planted fault: the naive split
    (_naive_split) against each bf16 flat launch at S in NAIVE_SPLIT_S
    must fail the bf16 gate."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 11)
    win, snk = _lc_windows(torch, dev)
    qlens = torch.tensor(LC_PARITY_QLENS, dtype=torch.int32, device=dev)
    lengths = BF16_PARITY_LENS["ctx4080"]
    B = len(lengths)
    cases, exact, naive = [], [], []
    errs = {"f32": [], "i8": [], "bf16": []}

    def on_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    for dtype, heads in CLUSTER_HEADS.items():
        for Hq, Hkv, D in heads:
            full, ids = _lc_pool(torch, serving, rng, Hq, Hkv, D, dtype, dev,
                                 lengths=lengths)
            ev, _ = _lc_pool(torch, serving, rng, Hq, Hkv, D, dtype, dev,
                             win, snk, lengths=lengths)
            t_f, ln_f = on_dev(*full.page_table_batch(ids))
            t_u, st_u, _ = on_dev(*full.page_tables_with_starts(ids))
            t_c, st_c, ln_c = on_dev(*ev.page_tables_with_starts(ids))
            tl, ln_tl = ev.two_level_tables(ids, LC_BLOCK)
            tl, ln_tl = _two_level_on(torch, pa, tl, dev), on_dev(ln_tl)[0]
            for ln in (ln_f, ln_c, ln_tl):
                ln[-1] = 0
            wk = {"windows": win, "sinks": snk}
            walks = [("flat", full, t_f, ln_f, {}),
                     ("starts_unevicted", full, t_u, ln_f,
                      dict(wk, page_starts=st_u)),
                     ("compacted", ev, t_c, ln_c, dict(wk, page_starts=st_c)),
                     ("two_level", ev, tl, ln_tl, wk)]
            tag = f"{dtype}_Hq{Hq}_Hkv{Hkv}_D{D}"
            for sq in (1, SPEC_D + 1):
                q = torch.randn(B, Hq, sq, D, generator=rng, device=dev)
                ql = qlens if sq > 1 else None
                rows = _valid_rows(torch, qlens, sq, dev)
                got_at = {}
                for walk, pool, t, ln, kw in walks:
                    kp, vp = pool.k_pages[0], pool.v_pages[0]
                    ks, vs = pool.layer_scales(0)
                    if dtype == "bfloat16":
                        want = pa.paged_bf16_reference(
                            q, kp, vp, t, ln, ql, kw.get("page_starts"),
                            kw.get("windows"), kw.get("sinks"), D ** -0.5)
                    else:
                        want = pa.paged_windowed_reference(
                            q, kp, vp, t, ln, ql, kw.get("page_starts"),
                            kw.get("windows"), kw.get("sinks"), D ** -0.5,
                            ks, vs)
                    own = pa.cluster_for(q, kp, t)
                    for S in CLUSTER_FORCED + (None,):
                        got = pa.paged_decode_attention(
                            q, kp, vp, t, ln, q_lengths=ql, k_scales=ks,
                            v_scales=vs, _cluster=S, **kw)
                        torch.cuda.synchronize()
                        name = (f"{tag}_sq{sq}_{walk}_S"
                                f"{S if S is not None else f'{own}(own)'}")
                        if dtype == "bfloat16":
                            g = _rows_gate(got, want, rows)
                        else:
                            m = rows.expand_as(got)
                            err = float((got - want)[m].abs().max())
                            bound = PARITY_TOL * max(
                                1.0, float(want[m].abs().max()))
                            g = {"max_abs_err": err, "bound": bound,
                                 "ok": err <= bound}
                        cases.append(dict(case=name, **g))
                        errs[POOL_SFX[dtype][1:]].append(g["max_abs_err"])
                        got_at[walk, S] = got
                        if dtype == "bfloat16" and walk == "flat" \
                                and S in NAIVE_SPLIT_S:
                            naive.append(dict(case=name, **_rows_gate(
                                got, _naive_split(torch, pa, q, kp, vp, t,
                                                  ln, ql, S), rows)))
                for S in CLUSTER_FORCED + (None,):
                    for a, b, label in (
                            ("flat", None, "flat_launch_vs_starts_walk"),
                            ("two_level", "compacted",
                             "two_level_vs_compacted_starts_walk")):
                        if b is None:
                            kp, vp = full.k_pages[0], full.v_pages[0]
                            ks, vs = full.layer_scales(0)
                            other = pa.paged_decode_attention(
                                q, kp, vp, t_u, ln_f, q_lengths=ql,
                                k_scales=ks, v_scales=vs, page_starts=st_u,
                                _cluster=S)
                        else:
                            other = got_at[b, S]
                        torch.cuda.synchronize()
                        m = rows.expand_as(other)
                        diff = float((got_at[a, S] - other)[m].abs().max())
                        exact.append({"case": f"{tag}_sq{sq}_S{S}_{label}",
                                      "max_abs_diff": diff,
                                      "exact": diff == 0.0})
            del full, ev
    emit({"phase": "cluster_parity", "forced_S": list(CLUSTER_FORCED),
          "tolerance": f"fp32 / int8: max abs err <= {PARITY_TOL} * max(1, "
          f"max |plain|); bf16: <= {BF16_ULP} * max |plain| and at most "
          f"{MISMATCH_SHARE} not bit-equal; valid rows; the naive split "
          "must fail the bf16 gate",
          "lengths": lengths[:-1] + [0], "q_lengths_at_sq5": LC_PARITY_QLENS,
          "windows": win.tolist(), "sinks": snk.tolist(),
          "max_err_over_bound": max(c["max_abs_err"] / c["bound"]
                                    for c in cases),
          "bf16_max_mismatch_share": max(c["mismatch_share"] for c in cases
                                         if "mismatch_share" in c),
          "naive_split_min_share": min(c["mismatch_share"] for c in naive),
          "exact_identities_hold": all(c["exact"] for c in exact),
          "exact_identities": exact, "naive_split": naive, "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    caught = [c for c in naive if c["ok"]]
    if bad or caught or not naive:
        raise AssertionError(
            f"cluster parity: {len(bad)} cases beyond the gate {bad[:3]}; "
            f"{len(caught)} naive-split cases passed it {caught[:3]}")
    return {k: max(v) for k, v in errs.items()}


CLUSTER_SWEEP = (1, 2, 4, 8)


def _cluster_sweep(torch, run, sizes=CLUSTER_SWEEP):
    """{S: device ms} of run(S) at forced cluster sizes: the evidence for
    the wrapper's choice of S."""
    return {S: device_ms(torch, lambda: run(S)) for S in sizes}


def _cluster_shape(pa, q, k_pages, tables):
    """The cluster size S the wrapper launches these operands with, and
    the grid's blocks, for a timing row's shape."""
    B, Hq, Sq, D = q.shape
    Hkv = k_pages.shape[0]
    R = Hq // Hkv * Sq
    rt = min(R, 1024 // D)
    S = pa.cluster_for(q, k_pages, tables)
    return {"cluster_S": S, "grid_blocks": S * B * Hkv * -(-R // rt)}


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
    sfx = POOL_SFX[dtype]
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


def phase_longctx_bf16(torch, np):
    """The windowed long-context traffic of phase_longctx (MAX_BATCH prompts
    of LC_PROMPT tokens, window 512 + 16 sinks, MAX_NEW new tokens) over a
    bf16 pool, on flat tables with explicit starts and on two-level tables
    of 16-page blocks.  Gated as the fp32 arms are (_lc_gate: launches by
    walk and by variant, the bf16 entries only, eviction and the walk's
    width, the pool clean), tokens against the same arm through the plain
    versions on the card (paged_bf16_reference) by the near-tie rule, and
    the two arms against each other exactly; the logit distance to the
    fp32 two-level arm's tokens is reported."""
    from paddle_tpu_torch import serving

    cfg = serving.DecodeConfig(**dict(CFG, max_length=LC_MAX_LENGTH))
    params = serving.init_decode_params(cfg, seed=SEED)
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    plain = _plain_decoder_cls(serving)(cfg).load_jax_params(params)
    wreqs = make_longctx_requests(serving, np, window=LC_WINDOW)
    out, launches, res_by = {}, {}, {}
    for arm, walk, kw in (("bf16_windowed_flat", "starts", {}),
                          ("bf16_windowed_two_level", "two_level",
                           {"table_block": LC_BLOCK})):
        loop, pool, res, wall, launches[arm] = _lc_counted(
            torch, serving, model, cfg, wreqs, dtype="bfloat16", **kw)
        _lc_gate(np, cfg, loop, pool, res, launches[arm], arm, walk, True,
                 dtype="bfloat16")
        out[arm] = dict(_lc_summary(loop, wall, pool),
                        pool_bytes_per_token=pool.bytes_per_page()
                        / PAGE_SIZE)
        del pool
        want = serving.ContinuousBatchingLoop(
            plain, cfg, _lc_new_pool(serving, cfg, "bfloat16"),
            max_batch=MAX_BATCH, **kw).run(wreqs)
        diff, ties = _compare_tokens(res, want)
        out[arm + "_vs_plain"] = {"max_abs_logit_diff": diff,
                                  "near_ties": ties}
        res_by[arm] = res
    flat, two = (res_by["bf16_windowed_flat"],
                 res_by["bf16_windowed_two_level"])
    if [r.tokens for r in flat] != [r.tokens for r in two]:
        raise AssertionError("bf16 windowed arms: flat and two-level tokens "
                             "differ")
    f32 = serving.ContinuousBatchingLoop(
        model, cfg, _lc_new_pool(serving, cfg), max_batch=MAX_BATCH,
        table_block=LC_BLOCK).run(wreqs)
    out["two_level_vs_fp32_pool"] = {
        "max_abs_logit_diff": _logit_distance(np, two, f32),
        "same_tokens": sum(a.tokens == b.tokens for a, b in zip(two, f32))}
    emit({"phase": "longctx_bf16", "config": dict(CFG,
                                                  max_length=LC_MAX_LENGTH),
          "max_batch": MAX_BATCH, "page_size": PAGE_SIZE,
          "prompt_len": LC_PROMPT, "max_new_tokens": MAX_NEW,
          "window": LC_WINDOW, "sinks": LC_SINKS, "table_block": LC_BLOCK,
          "launches": launches, "arms": out})
    torch.cuda.empty_cache()
    return launches


# -- phase 3e: shared-prefix serving over bf16 pools ---------------------------

PREFIX_REQUESTS = 32
PREFIX_SHARE = 0.75    # tools/serve_bench.py --prefix-share
PREFIX_CHUNK = 64      # prefill_chunk: prefill tokens one step may take
PREFIX_REPEATS = 4     # requests that extend an earlier prompt
POOL_SFX = {"float32": "_f32", "int8": "_i8", "bfloat16": "_bf16"}
PREFIX_AB_ORDER = ("float32", "bfloat16", "bfloat16", "float32", "float32",
                   "bfloat16")
# the four counted runs: (name, pool dtype, prefix cache, speculate)
PREFIX_RUNS = (("bf16_cache", "bfloat16", True, 0),
               ("fp32_cache", "float32", True, 0),
               ("bf16_no_cache", "bfloat16", False, 0),
               ("bf16_cache_spec", "bfloat16", True, SPEC_D))


def make_prefix_requests(serving, np):
    """tools/serve_bench.py's decode traffic (``_decode_requests``) with
    --prefix-share 0.75 at --prompt-range 16,128, --max-len 256, --max-new
    32: one system prompt of 96 tokens (3/4 of the longest prompt) opens a
    request with probability 0.75, followed by 1-32 random tokens; the
    others are 16-128 random tokens.  PREFIX_REQUESTS - PREFIX_REPEATS
    requests from that generator, then PREFIX_REPEATS that extend one of
    the first MAX_BATCH prompts (one whose length is not a page multiple)
    by 1-8 tokens, at evenly spaced places after the first batch: such a
    request matches the earlier prompt's partly filled last page, which it
    attaches and copies on its first append.  (A verbatim repeat would
    match whole pages only: a match leaves the last prompt token
    uncached.)"""
    rng = np.random.RandomState(SEED)
    lo, hi = PROMPT_RANGE
    hi = min(hi, CFG["max_length"] - MAX_NEW)
    sys_prompt = rng.randint(1, CFG["vocab_size"],
                             size=max(1, int(hi * 0.75))).tolist()
    prompts = []
    for _ in range(PREFIX_REQUESTS - PREFIX_REPEATS):
        if rng.rand() < PREFIX_SHARE:
            tail = int(rng.randint(1, max(2, hi - len(sys_prompt) + 1)))
            prompts.append(sys_prompt + rng.randint(
                1, CFG["vocab_size"], size=tail).tolist())
        else:
            n = int(rng.randint(lo, max(lo + 1, hi + 1)))
            prompts.append(rng.randint(1, CFG["vocab_size"],
                                       size=n).tolist())
    bases = [p for p in prompts[:MAX_BATCH] if len(p) % PAGE_SIZE]
    step = (len(prompts) - MAX_BATCH) // PREFIX_REPEATS
    for i in range(PREFIX_REPEATS):
        extra = rng.randint(1, CFG["vocab_size"],
                            size=int(rng.randint(1, 9))).tolist()
        prompts.insert(MAX_BATCH + (i + 1) * step + i,
                       bases[i % len(bases)] + extra)
    return [serving.DecodeRequest(prompt=p, max_new_tokens=MAX_NEW)
            for p in prompts]


def _prefix_pool(serving, cfg, dtype):
    """Room for every request's worst case at once, so the cache keeps
    every entry (no pressure eviction) and the repeats find their pages."""
    per_seq = -(-(PROMPT_RANGE[1] + 8 + MAX_NEW) // PAGE_SIZE)
    return serving.KVCachePool(
        num_pages=PREFIX_REQUESTS * per_seq + 16, page_size=PAGE_SIZE,
        num_layers=cfg.n_layer, num_heads=cfg.n_head, head_dim=cfg.head_dim,
        num_kv_heads=cfg.num_kv_heads, dtype=dtype)


def _prefix_run(torch, serving, model, cfg, reqs, dtype, cached, d):
    """One loop run of the shared-prefix traffic with every counter zeroed
    just before it and read just after.  Returns (loop, pool, cache,
    results, wall_s, t0, launches)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import paged_attention as pa

    pool = _prefix_pool(serving, cfg, dtype)
    cache = serving.PrefixCache(pool) if cached else None
    loop = serving.ContinuousBatchingLoop(model, cfg, pool,
                                          max_batch=MAX_BATCH,
                                          prefix_cache=cache,
                                          prefill_chunk=PREFIX_CHUNK,
                                          speculate=d)
    torch.cuda.synchronize()
    fa.reset_launches()
    pa.reset_launches()
    t0 = time.perf_counter()
    results = loop.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pa.paged_decode_attention.launches_by_variant,
                    flash_fwd=fa.flash_attention.launches)
    return loop, pool, cache, results, wall, t0, launches


PREFIX_COUNTERS = ("prefix_hits", "prefix_misses", "cached_prefill_tokens",
                   "prefill_steps", "prefill_tokens",
                   "max_prefill_tokens_step")


def phase_prefix_serving(torch, np):
    """Shared-prefix serving at the Transformer-base width: the
    make_prefix_requests traffic (32 requests, MAX_NEW new tokens each),
    max_batch 8, page 16, prefill_chunk 64, in four counted runs:
    bf16 pool + PrefixCache; fp32 pool + PrefixCache; bf16 pool without a
    cache; bf16 pool + PrefixCache with speculate=4.  Each run against the
    same run through the plain versions on the card: tokens by the
    near-tie rule, and prefix_hits, prefix_misses, cached_prefill_tokens,
    prefill_steps, prefill_tokens, max_prefill_tokens_step (<= 64) and the
    pool's cow_copies and shared_attach_pages equal.  A cached run copies
    at least one shared page (cow_copies >= 1); after cache.clear() the
    pool is empty with its invariants ok.  Launches: decode and verify
    steps x n_layer of the run's dtype variants and none of any other
    (so a bf16 run launches only bf16 entries, the fp32 run none of
    them); no flash launch (every prompt prefills in chunk steps).  Per
    run: tokens/s, host-clock time to first token (from admission, and
    from the run's start) p50 and p99, prefill tokens, pages allocated,
    pool bytes per token; the bf16 cached run once more under
    torch.profiler for the busy share."""
    from paddle_tpu_torch import serving

    cfg = serving.DecodeConfig(**CFG)
    params = serving.init_decode_params(cfg, seed=SEED)
    model = serving.TransformerDecoder(cfg).load_jax_params(params)
    plain = _plain_decoder_cls(serving)(cfg).load_jax_params(params)
    reqs = make_prefix_requests(serving, np)
    # warm-up: the chunk step's einsums and the bf16 entries, once
    warm = _prefix_pool(serving, cfg, "bfloat16")
    serving.ContinuousBatchingLoop(
        model, cfg, warm, max_batch=MAX_BATCH,
        prefix_cache=serving.PrefixCache(warm),
        prefill_chunk=PREFIX_CHUNK).run(reqs[:MAX_BATCH])
    del warm
    out, launches = {}, {}
    for name, dtype, cached, d in PREFIX_RUNS:
        loop, pool, cache, res, wall, t0, launches[name] = _prefix_run(
            torch, serving, model, cfg, reqs, dtype, cached, d)
        n = cfg.n_layer
        sfx = POOL_SFX[dtype]
        want = {k: 0 for k in launches[name]}
        want["verify" + sfx] = loop.spec_steps * n
        want["decode" + sfx] = (loop.decode_steps - loop.spec_steps) * n
        if launches[name] != want or not want["decode" + sfx] \
                or (d and not want["verify" + sfx]):
            raise AssertionError(f"{name}: launches {launches[name]}, want "
                                 f"{want}")
        stats = pool.stats()
        if cache is not None:
            if not (stats["cow_copies"] >= 1 and loop.prefix_hits > 0):
                raise AssertionError(f"{name}: {loop.prefix_hits} hits, "
                                     f"{stats['cow_copies']} cow copies")
            cache.clear()
        if loop.max_prefill_tokens_step > PREFIX_CHUNK:
            raise AssertionError(f"{name}: a step prefilled "
                                 f"{loop.max_prefill_tokens_step} tokens")
        _check_run(np, cfg, loop, pool, res, name)
        # the same run through the plain versions on the card
        ploop, ppool, _, pres = _prefix_run(torch, serving, plain, cfg,
                                            reqs, dtype, cached, d)[:4]
        diff, ties = _compare_tokens(res, pres)
        got = {k: getattr(loop, k) for k in PREFIX_COUNTERS}
        got.update(cow_copies=stats["cow_copies"],
                   shared_attach_pages=stats["shared_attach_pages"])
        ref = {k: getattr(ploop, k) for k in PREFIX_COUNTERS}
        ref.update(cow_copies=ppool.stats()["cow_copies"],
                   shared_attach_pages=ppool.stats()["shared_attach_pages"])
        if got != ref and not ties:  # a near-tie may move admissions
            raise AssertionError(f"{name}: counters {got} vs plain {ref}")
        ttft = [r.ttft_s for r in res]
        first = [r.admitted_at + r.ttft_s - t0 for r in res]
        n_tok = sum(len(r.tokens) for r in res)
        out[name] = {
            "pool": dtype, "prefix_cache": cached, "speculate": d,
            "counters": got, "plain_counters": ref,
            "steps": loop.steps, "decode_steps": loop.decode_steps,
            "spec_steps": loop.spec_steps,
            "accepted_tokens": loop.accepted_tokens,
            "wall_s": wall, "tokens_per_s": n_tok / wall,
            "ttft_from_admission_ms": {
                "p50": 1e3 * float(np.percentile(ttft, 50)),
                "p99": 1e3 * float(np.percentile(ttft, 99))},
            "ttft_from_run_start_ms": {
                "p50": 1e3 * float(np.percentile(first, 50)),
                "p99": 1e3 * float(np.percentile(first, 99))},
            "prefill_tokens": loop.prefill_tokens,
            "pages_allocated": stats["page_allocs"],
            "used_pages_high_water": stats["used_pages_high_water"],
            "pool_bytes_per_token": pool.bytes_per_page() / PAGE_SIZE,
            "prefill_step_ms_median": 1e3 * statistics.median(
                loop.prefill_step_s),
            "decode_step_ms_median": (1e3 * statistics.median(
                loop.decode_step_s) if loop.decode_step_s else None),
            "vs_plain": {"max_abs_logit_diff": diff, "near_ties": ties},
            "tokens": [r.tokens for r in res]}
        del pool, ppool
    bf, fp = out["bf16_cache"], out["fp32_cache"]
    if bf["pool_bytes_per_token"] * 2 != fp["pool_bytes_per_token"]:
        raise AssertionError("a bf16 pool must hold half an fp32 pool's bytes")
    # host-clock tokens/s move with the order of the runs: the two cached
    # runs once more in PREFIX_AB_ORDER, for timing only (each rerun's
    # count of requests with the gated run's tokens is reported)
    ab = {"float32": [], "bfloat16": [], "same_tokens": []}
    for dtype in PREFIX_AB_ORDER:
        _, pool, _, res, wall = _prefix_run(torch, serving, model, cfg, reqs,
                                            dtype, True, 0)[:5]
        name = "bf16_cache" if dtype == "bfloat16" else "fp32_cache"
        ab[dtype].append(sum(len(r.tokens) for r in res) / wall)
        ab["same_tokens"].append(sum(
            r.tokens == t for r, t in zip(res, out[name]["tokens"])))
        del pool
    for r in out.values():
        del r["tokens"]
    trace = _trace(torch, serving, model, cfg, reqs, bf["wall_s"],
                   prefix_dtype="bfloat16", prefill_chunk=PREFIX_CHUNK)
    emit({"phase": "prefix_serving", "config": CFG, "max_batch": MAX_BATCH,
          "page_size": PAGE_SIZE, "requests": len(reqs),
          "prefix_share": PREFIX_SHARE, "prefill_chunk": PREFIX_CHUNK,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "max_new_tokens": MAX_NEW, "launches": launches, "runs": out,
          "ab_tokens_per_s": {"order": PREFIX_AB_ORDER,
                              "fp32_cache": ab["float32"],
                              "bf16_cache": ab["bfloat16"],
                              "same_tokens": ab["same_tokens"]},
          "trace_bf16_cache": trace})
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
            table_bytes, shape, walk_t=None):
        """``walk_t``: the tables the kernel walks (a TwoLevelTables over
        the flat ``t``), for the cluster size."""
        shape = dict(shape, **_cluster_shape(
            pa, q, kp, t if walk_t is None else walk_t))
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
    sweep = {"paged_decode_4080": _cluster_sweep(
        torch, lambda S: pa.paged_decode_attention(q, kp, vp, t, ln,
                                                   _cluster=S))}
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
    sweep["paged_starts_window_34_pages"] = _cluster_sweep(
        torch, lambda S: pa.paged_decode_attention(
            q, kp, vp, t, ln, page_starts=st, windows=win, sinks=snk,
            _cluster=S))
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
        dict(shape, block_size=LC_BLOCK), walk_t=tl))
    emit({"phase": "longctx_timing", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": "SDPA over K/V already gathered through the "
          "table, boolean mask of the visible keys (gather not timed)",
          "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "shape")}
                   for r in [flat] + rows],
          "cluster_sweep_ms": sweep})
    for r in rows:
        r.pop("shape")
    flat.pop("shape")
    return rows, {k: flat[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}


def phase_bf16_paged_timing(torch, np, reqs, spec_reqs, errs, launches):
    """The bf16 entries of kernel row 4 at the fp32 rows' shapes, on pages
    a bf16 pool's write_kv filled (B 8, H = H_kv 8, D 64, page 16): 4a
    (decode_bf16) at a mid-generation step of the first admitted group of
    the serving requests and over a 4080-token context; 4b (verify_bf16,
    Sq 5, every block full) at that step of the speculative requests; 4d
    (starts walk, window 512 + 16 sinks) and 4e (two-level, blocks of 16)
    at the long-context decode shape after eviction (34 live pages).
    Bound: the K/V rows the queries see read once at 2 bytes an element,
    plus fp32 q and o and the int32 table operands, over 3.35 TB/s,
    against 4 * D operations per visible (row, key) pair over the dense
    bf16 peak.  Plain: paged_bf16_reference.  Library: SDPA in bf16 (q
    rounded, K/V already gathered through the table, a boolean mask of the
    visible keys; gather not timed).  Launches: the counted runs of
    phase_prefix_serving (4a, 4b) and phase_longctx_bf16 (4d, 4e)."""
    import torch.nn.functional as F

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 10)
    H, D = CFG["n_head"], CFG["d_model"] // CFG["n_head"]
    scale = D ** -0.5
    src = "paddle_tpu_torch/kernels/csrc/paged_decode.cu"
    tpu = "paddle_tpu/kernels/paged_attention.py:645"
    prefix = launches["prefix"]
    rows, extra = [], {}

    def timed(name, n_launch, err, q, kp, vp, t, ln, vis, kw, tbytes, shape,
              flat_t=None):
        """One row; ``flat_t`` is the flat table behind a TwoLevelTables
        ``t`` (the gather and ``vis`` follow it)."""
        n_vis = int(vis.sum()) * H
        B, _, sq, _ = q.shape
        kg = pa.gather_kv_pages(kp, t if flat_t is None else flat_t)
        vg = pa.gather_kv_pages(vp, t if flat_t is None else flat_t)
        n_keys = int(vis.any(2).sum())  # keys some row sees, read once
        nbytes = 2 * 2 * H * D * n_keys + 4 * 2 * B * H * sq * D + tbytes
        qb = q.to(torch.bfloat16)
        return _row(
            name, src, tpu, n_launch, err,
            device_ms(torch, lambda: pa.paged_decode_attention(
                q, kp, vp, t, ln, **kw)),
            device_ms(torch, lambda: pa.paged_bf16_reference(
                q, kp, vp, t, ln, kw.get("q_lengths"),
                kw.get("page_starts"), kw.get("windows"), kw.get("sinks"),
                scale)),
            nbytes, 4 * D * n_vis,
            device_ms(torch, lambda: F.scaled_dot_product_attention(
                qb, kg, vg, attn_mask=vis, scale=scale)),
            dict(shape, visible_pairs_per_head=n_vis // H,
                 **_cluster_shape(pa, q, kp, t)),
            flops_per_s=BF16_FLOPS_PER_S)

    def flat_vis(ln, kv_len, sq):
        j = torch.arange(kv_len, device=dev)
        pos_q = (ln.long() - sq)[:, None] + torch.arange(sq, device=dev)
        return ((j[None, None, :] <= pos_q[:, :, None])
                & (j[None, None, :] < ln.long()[:, None, None]))[:, None]

    # 4a and 4b at the serving shapes
    for name, rq, sq, n_launch in (
            ("paged_decode_bf16", reqs, 1,
             sum(v["decode_bf16"] for v in prefix.values())),
            ("paged_verify_bf16", spec_reqs, SPEC_D + 1,
             sum(v["verify_bf16"] for v in prefix.values()))):
        lens = [len(r.prompt) + MAX_NEW // 2 for r in rq[:MAX_BATCH]]
        pool, t, ln = _pool_layer(torch, serving, rng, H, H, D, lens,
                                  "bfloat16", dev)
        kp, vp = pool.k_pages[0], pool.v_pages[0]
        q = torch.randn(len(lens), H, sq, D, generator=rng, device=dev)
        kw = ({"q_lengths": torch.full((len(lens),), sq, dtype=torch.int32,
                                       device=dev)} if sq > 1 else {})
        extra[name] = _cluster_sweep(
            torch, lambda S: pa.paged_decode_attention(q, kp, vp, t, ln,
                                                       _cluster=S, **kw),
            (1, 2))
        rows.append(timed(
            name, n_launch, errs[name[len("paged_"):]], q, kp, vp, t, ln,
            flat_vis(ln, t.shape[1] * PAGE_SIZE, sq), kw,
            4 * (t.numel() + 2 * len(lens)),
            {"B": len(lens), "H_q": H, "H_kv": H, "D": D, "Sq": sq,
             "page_size": PAGE_SIZE, "lengths": lens}))
        del pool

    # 4a over a 4080-token context, then 4d and 4e on the same pages
    # evicted, as phase_longctx_timing
    B, L = MAX_BATCH, LC_PROMPT + MAX_NEW // 2
    pool = serving.KVCachePool(B * -(-L // PAGE_SIZE) + 4, PAGE_SIZE, 1, H, D,
                               dtype="bfloat16")
    ids = list(range(B))
    for i in ids:
        pool.allocate(i)

    def fill(n):
        pg, sl = pool.append_tokens(ids, [n] * B)
        pool.write_kv(0, pg, sl,
                      torch.randn(len(pg), H, D, generator=rng, device=dev),
                      torch.randn(len(pg), H, D, generator=rng, device=dev))

    fill(L)
    kp, vp = pool.k_pages[0], pool.v_pages[0]
    q = torch.randn(B, H, 1, D, generator=rng, device=dev)
    t, st, ln = (torch.as_tensor(a, device=dev)
                 for a in pool.page_tables_with_starts(ids))
    flat = timed("paged_decode_bf16", 0, errs["decode_bf16"], q, kp, vp, t,
                 ln, flat_vis(ln, t.shape[1] * PAGE_SIZE, 1), {},
                 4 * (t.numel() + B),
                 {"B": B, "H_q": H, "H_kv": H, "D": D, "page_size": PAGE_SIZE,
                  "lengths": [L] * B, "table_pages": t.shape[1]})
    extra["at_long_context"] = {k: flat[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")}
    extra["paged_decode_bf16_4080"] = _cluster_sweep(
        torch, lambda S: pa.paged_decode_attention(q, kp, vp, t, ln,
                                                   _cluster=S))
    for i in ids:
        pool.truncate_seq(i, L - 1)
        pool.evict_interior(i, LC_WINDOW, LC_SINKS)
    fill(1)
    t, st, ln = (torch.as_tensor(a, device=dev)
                 for a in pool.page_tables_with_starts(ids))
    win = torch.full((B,), LC_WINDOW, dtype=torch.int32, device=dev)
    snk = torch.full((B,), LC_SINKS, dtype=torch.int32, device=dev)
    vis = _lc_visible(torch, pa, t, st, ln, win, snk, dev)
    shape = {"B": B, "H_q": H, "H_kv": H, "D": D, "page_size": PAGE_SIZE,
             "lengths": [L] * B, "window": LC_WINDOW, "sinks": LC_SINKS,
             "live_pages": t.shape[1]}
    extra["paged_starts_window_bf16_34_pages"] = _cluster_sweep(
        torch, lambda S: pa.paged_decode_attention(
            q, kp, vp, t, ln, page_starts=st, windows=win, sinks=snk,
            _cluster=S))
    lc = launches["longctx"]
    rows.append(timed(
        "paged_starts_window_bf16",
        lc["bf16_windowed_flat"]["by_table"]["starts"], errs["starts"], q,
        kp, vp, t, ln, vis, dict(page_starts=st, windows=win, sinks=snk),
        4 * (2 * t.numel() + 3 * B), shape))
    tl, _ = pool.two_level_tables(ids, LC_BLOCK)
    tl = _two_level_on(torch, pa, tl, dev)
    rows.append(timed(
        "paged_two_level_bf16",
        lc["bf16_windowed_two_level"]["by_table"]["two_level"],
        errs["two_level"], q, kp, vp, tl, ln, vis,
        dict(windows=win, sinks=snk),
        4 * (tl.l1.numel() + tl.l2.numel() + tl.starts.numel() + 3 * B),
        dict(shape, block_size=LC_BLOCK), flat_t=t))
    emit({"phase": "bf16_paged_timing", "method": "CUDA events, median of "
          "30 after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": "SDPA in bf16 over K/V already gathered through "
          "the table, boolean mask of the visible keys (gather not timed)",
          "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "shape")}
                   for r in rows],
          "paged_decode_bf16_at_long_context": extra["at_long_context"],
          "cluster_sweep_ms": {k: v for k, v in extra.items()
                               if k != "at_long_context"}})
    for r in rows:
        r.pop("shape")
    extra["at_long_context"].pop("shape")
    rows[0]["at_long_context"] = extra["at_long_context"]
    return rows


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
    by_kind = {}
    for name, us in by_name.items():
        kind = next((k for k, ms in _TRAIN_KINDS
                     if any(m in name for m in ms)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
    return {"traced_wall_s": wall, "device_busy_s": busy_s,
            "busy_share": busy_s / step_wall,
            "flash_ms": {k: us / 1e3 for k, us in flash_us.items()},
            "flash_share_of_busy": sum(flash_us.values()) / 1e6 / busy_s,
            "device_ms_by_kind": by_kind,
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


# bf16 convs with C % 8 != 0 that the stem's kernel does not take, so the
# im2col kernel gathers A from x: w's chunks past the six the stem's
# kernel keeps, two windows and w past its shared memory, and a window
# past 64 KB
CONV_PATH_CASES = [(2, 17, 15, 20, 24, 5, 1, 2, False, "relu"),
                   (1, 2, 300, 37, 16, 3, 1, 1, False, ""),
                   (1, 3, 600, 37, 16, 3, 1, 1, False, "")]


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


def _relaunch_equal(torch, ce, x, w, s, p, first):
    """Whether conv_stats launched again on the same inputs gives out, sum
    and sumsq bit-equal to ``first`` (no atomics: the partial sums are
    reduced in a fixed order)."""
    again = ce.conv_stats(x, w, s, p)
    return all(bool(torch.equal(a, b)) for a, b in zip(first, again))


def _check_relaunch(relaunch, dtype):
    bad = [r["case"] for r in relaunch if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"{dtype} conv_stats relaunched is not "
                             f"bit-equal: {bad}")


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
    cases += CONV_PATH_CASES
    out_rows, errs, relaunch = [], {k: [] for k in CONV_KERNELS}, []

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
        relaunch.append({"case": name, "bit_equal": _relaunch_equal(
            torch, ce, x, w, s, p, (out, ssum, ssq))})
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
          "cases": out_rows, "conv_stats_relaunch": relaunch})
    bad = [r for r in out_rows if not r["max_abs_err"] <= r["bound"]]
    if bad:
        raise AssertionError(f"conv-epilogue parity beyond its bound: {bad}")
    _check_relaunch(relaunch, "fp32")
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
    (the backward is plain torch and cuDNN).  The steps and the profiled
    step run with cuDNN deterministic, so that the trajectory, and the
    gate on it, are the same on every call."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce

    main, startup, spec, params_grads = build_resnet(fluid)
    n_conv = sum(conv_classes(main, RESNET_BATCH).values())
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    init_state = _persistables(startup, scope)
    n_params = sum(int(np.prod(p.shape)) for p, _ in params_grads)
    batch = spec.synthetic_batch(RESNET_BATCH, seed=SEED)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
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
        launches = _conv_counts(ce)
        by_dtype = _conv_counts_by_dtype(ce)
        by_shape = dict(ce.conv_stats.launches_by_shape)
        copies = ce.conv_bn_act.layout_copies
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        step_med = statistics.median(step_s)
        trace = _trace_resnet(torch, exe, main, spec, batch, scope,
                              step_med)
    finally:
        torch.backends.cudnn.deterministic = deterministic
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
          "cudnn_deterministic": True,
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

# kernel names of a training step by kind, first match wins: the port's
# flash kernels, then _KINDS without the conv-epilogue kernels
_TRAIN_KINDS = (("flash_bwd", ("flash_bwd",)), ("flash_fwd", ("flash_fwd",)),
                *_KINDS[2:])


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
    cases += CONV_PATH_CASES
    rows, faults, vs_fp32, relaunch = [], [], [], []
    errs = {k: [] for k in CONV_KERNELS}
    for N, H, W, C, Fo, K, s, p, res, act in cases:
        name = f"{N}x{H}x{W}x{C}->{Fo} k{K}s{s}p{p}{' +z' if res else ''}" \
               f"{' relu' if act else ''}"
        x, w, gamma, beta = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        x, w = x.to(bf16), w.to(bf16)
        out, ssum, ssq = ce.conv_stats(x, w, s, p)
        relaunch.append({"case": name, "bit_equal": _relaunch_equal(
            torch, ce, x, w, s, p, (out, ssum, ssq))})
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
          "conv_stats_relaunch": relaunch,
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
    _check_relaunch(relaunch, "bf16")
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


# -- phase 5a: the training paths through Executor.run_steps ------------------

RUN_STEPS_K = 10       # steps a run_steps call, and steps an eager arm
FLAT_K = 2             # steps of the flat-against-scan check
RUN_STEPS_CALLS = 3    # timed run_steps calls after the gated one
PAD_CYCLES = 20_000_000  # a device sleep of about 10 ms marks a trace
# path -> (AMP keep_output, or None for fp32; the kernels' dtype)
RUN_STEPS_PATHS = {"transformer_keep": (True, "bfloat16"),
                   "transformer_fp32": (None, "float32"),
                   "resnet_keep": (True, "bfloat16")}
# a kernel wrapper's launches as the profiler names them: the flash
# kernels one each; conv_stats by its main kernel (its two partial-sum
# reductions are not counted), bn_epilogue by either of its kernels
PROFILED_LAUNCHES = {"flash_fwd": ("flash_fwd_",),
                     "flash_bwd_dq": ("flash_bwd_dq_",),
                     "flash_bwd_dkv": ("flash_bwd_dkv_",),
                     "conv_stats": ("conv_stats_bf16_kernel",
                                    "conv_stats_bf16_rows_kernel",
                                    "conv_stats_f32_kernel"),
                     "bn_epilogue": ("bn_epilogue",)}


def _run_steps_path(fluid, name):
    """(main, startup, spec, batch size, counts by dtype, launches a
    step) of one run_steps path: bench's Transformer, Transformer-base
    fp32 or ResNet-50's conv tier, as the earlier phases build them."""
    from paddle_tpu_torch.kernels import conv_epilogue as ce
    from paddle_tpu_torch.kernels import flash_attention as fa

    if name == "resnet_keep":
        main, startup, spec, _ = build_resnet(fluid, form="conv")
        return (main, startup, spec, RESNET_BATCH,
                lambda: _conv_counts_by_dtype(ce), 53)
    main, startup, spec, _ = (build_bench_transformer(fluid)
                              if name == "transformer_keep"
                              else build_training(fluid))
    return (main, startup, spec, TRAIN_BATCH,
            lambda: _flash_counts_by_dtype(fa),
            3 * spec.extras["config"].n_layer)


def _state_on_host(startup, scope):
    """{name: a copy in host memory} of every persistable (kept off the
    card, so that the arms' peak memory holds no comparison copies)."""
    return {n: scope.find_var(n).detach().cpu()
            for n, v in startup.desc.block(0).vars.items() if v.persistable}


def _state_distance(torch, got, want):
    """(max |got - want| over every persistable, names not bit-equal)."""
    worst, differ = 0.0, []
    for n, w in want.items():
        if not torch.equal(got[n], w):
            differ.append(n)
            worst = max(worst, float((got[n].double() - w.double())
                                     .abs().max()))
    return worst, differ


def _profiled(torch, fn, marks=PROFILED_LAUNCHES):
    """fn() under torch.profiler: wall s, device busy s, launches by
    PROFILED_LAUNCHES from the kernel names, device ms by kind and the
    number of device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    if not busy_s:
        raise AssertionError("the profiler saw no device time")
    by_kind = {}
    for e in events:
        kind = next((k for k, ms in _TRAIN_KINDS[:2] + _KINDS
                     if any(m in e.key for m in ms)), "other")
        by_kind[kind] = (by_kind.get(kind, 0.0)
                         + e.self_device_time_total / 1e3)
    return {"wall_s": wall, "busy_s": busy_s,
            "launches": {k: sum(e.count for e in events
                                if any(m in e.key for m in ms))
                         for k, ms in marks.items()},
            "device_ms_by_kind": by_kind,
            "device_records": sum(e.count for e in events)}


def _second_call_launches(torch, fn, between, marks=PROFILED_LAUNCHES):
    """fn() twice in one torch.profiler trace, ``between()`` and a device
    sleep between them: the second call's launches by PROFILED_LAUNCHES
    from the kernel names (kernels that start after the sleep's), its
    device records, and the trace's first 24 kernel names.  Late in the
    script a trace lost up to 21 of the first kernel records of its first
    replayed graph (the first call's here), on an H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        between()
        torch.cuda._sleep(PAD_CYCLES)
        fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    marker = [e.time_range.start for e in kernels if "spin_kernel" in e.name]
    if len(marker) != 1:
        raise AssertionError(f"the trace holds {len(marker)} device sleeps, "
                             "want 1")
    second = [e.name for e in kernels if e.time_range.start > marker[0]]
    return {"launches": {k: sum(any(m in n for m in ms) for n in second)
                         for k, ms in marks.items()},
            "device_records": len(second),
            "trace_head": [e.name[:60] for e in kernels[:24]]}


def _assign_value_on_card(torch, np, fluid):
    """A tiny program whose constant comes from assign_value, through
    run_steps on the card: its fetch equal to the CPU executor's."""
    from paddle_tpu_torch.core.proto import DataType
    from paddle_tpu_torch.layer_helper import LayerHelper

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4], dtype="float32")
        helper = LayerHelper("assign_value")
        c = helper.create_variable_for_type_inference(DataType.FP32)
        helper.append_op(type="assign_value", outputs={"Out": [c]},
                         attrs={"shape": [4], "dtype": int(DataType.FP32),
                                "fp32_values": [0.5, -1.25, 2.0, 3.75]})
        out = fluid.layers.mean(fluid.layers.elementwise_add(x, c))
    rng = np.random.default_rng(SEED + 13)
    feeds = [{"x": rng.standard_normal((2, 4)).astype(np.float32)}
             for _ in range(2)]
    got, want = [
        exe.run_steps(main, feed_list=feeds, fetch_list=[out], steps=3,
                      scope=fluid.Scope())[0]
        for exe in (fluid.Executor(), fluid.Executor(fluid.CPUPlace()))]
    if not np.array_equal(got, want):
        raise AssertionError(f"assign_value through run_steps: {got} on "
                             f"the card, {want} on the CPU")
    return {"fetch": got.tolist(), "cpu": want.tolist()}


def phase_run_steps_training(torch, np, fluid):
    """The three training paths through ``Executor.run_steps`` on the
    card: bench's Transformer under keep (dropout 0.1, the bf16 flash
    kernels), Transformer-base in fp32 (the fp32 flash kernels) and
    ResNet-50's conv tier under keep (conv_stats_bf16, bn_epilogue_bf16),
    at the earlier phases' widths, batches and optimizers, with cuDNN
    deterministic.  Per path, from one startup state and two batches
    (seeds SEED and SEED + 1) staged on the card once: two eager arms of
    RUN_STEPS_K ``run`` steps, then ``run_steps(steps=RUN_STEPS_K)``
    (mode scan: one step captured and replayed).  The replay's final
    persistables and last loss must lie no farther from the first eager
    arm's than the second eager arm does (bit-equal where that is 0); the
    counters, zeroed just before the call, must read RUN_STEPS_K times the
    eager step's launches in the path's dtype and none in the other.  A
    profiled replayed call of FLAT_K steps (the same one-step graph,
    captured anew) must show FLAT_K times them by kernel name, and the
    counters the same: the second of two such calls in one trace, since
    the profiler drops records of graph kernels, more over a long call,
    and late in the script the first records of a trace's first
    replayed graph.  Then
    three timed calls (step time = call time / RUN_STEPS_K), a profiled
    ten-step call (busy share, device time by kind), the capture and the
    warm-up, peak memory of both arms, the bytes of every
    persistable beside the profiled call's copies (the captured step ends
    by copying each new state into its buffer), and flat against
    scan at FLAT_K steps, bit-equal.  Last, assign_value through
    run_steps."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    paths, launches = {}, {}
    try:
        for name, (keep, dtype) in RUN_STEPS_PATHS.items():
            paths[name], launches[name] = _run_steps_one(
                torch, np, fluid, name, keep, dtype)
            torch.cuda.empty_cache()
        assign = _assign_value_on_card(torch, np, fluid)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "run_steps_training", "card": card_line(),
          "steps_a_call": RUN_STEPS_K, "paths": paths,
          "assign_value": assign})
    return launches


def _run_steps_one(torch, np, fluid, name, keep, dtype):
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    main, startup, spec, batch, counts, per_step = _run_steps_path(fluid,
                                                                   name)
    dev = torch.device("cuda")
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = _persistables(startup, scope)
    del scope
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in
              spec.synthetic_batch(batch, seed=s).items()}
             for s in (SEED, SEED + 1)]

    def loaded():
        scope = fluid.Scope()
        exe.load_state(init, scope)
        return scope

    def reset():
        from paddle_tpu_torch.kernels import conv_epilogue as ce
        from paddle_tpu_torch.kernels import flash_attention as fa

        fa.reset_launches()
        ce.reset_launches()

    if keep is not None:
        fluid.enable_amp("bfloat16", keep_output=keep)
    try:
        # two eager arms
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eager, step_s = [], []
        for _ in range(2):
            scope = loaded()
            reset()
            for i in range(RUN_STEPS_K):
                t0 = time.perf_counter()
                loss, = exe.run(main, feed=feeds[i % 2],
                                fetch_list=[spec.loss], scope=scope)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            eager_counts = counts()
            eager.append((float(loss.reshape(-1)[0]),
                          _state_on_host(startup, scope)))
        eager_peak = torch.cuda.max_memory_allocated() / 2**30
        eager_prof = _profiled(
            torch, lambda: exe.run(main, feed=feeds[0],
                                   fetch_list=[spec.loss], scope=scope))
        del scope
        # run_steps: captured on the first call, then replayed
        rexe, scope = fluid.Executor(), loaded()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        loss, = rexe.run_steps(main, feed_list=feeds,
                               fetch_list=[spec.loss], steps=RUN_STEPS_K,
                               scope=scope)
        torch.cuda.synchronize()
        first_call_s = time.perf_counter() - t0
        got_counts = counts()
        replay = (float(loss.reshape(-1)[0]),
                  _state_on_host(startup, scope))
        graph_peak = torch.cuda.max_memory_allocated() / 2**30
        call_s = []
        for _ in range(RUN_STEPS_CALLS):
            t0 = time.perf_counter()
            rexe.run_steps(main, feed_list=feeds, fetch_list=[spec.loss],
                           steps=RUN_STEPS_K, scope=scope)
            torch.cuda.synchronize()
            call_s.append(time.perf_counter() - t0)
        long_prof = _profiled(
            torch, lambda: rexe.run_steps(
                main, feed_list=feeds, fetch_list=[spec.loss],
                steps=RUN_STEPS_K, scope=scope))
        capture = dict(rexe.last_capture)
        copy_bytes = 2 * sum(t.numel() * t.element_size()
                             for t in replay[1].values())
        del rexe, scope
        # flat against scan, FLAT_K steps each
        flat = {}
        for mode in ("scan", "flat"):
            fexe, fscope = fluid.Executor(), loaded()
            fl, = fexe.run_steps(main, feed_list=feeds,
                                 fetch_list=[spec.loss], steps=FLAT_K,
                                 scope=fscope, mode=mode)
            flat[mode] = (float(fl.reshape(-1)[0]),
                          _state_on_host(startup, fscope))
            if mode == "scan":  # the same one-step graph, replayed
                prof = _second_call_launches(torch, lambda: fexe.run_steps(
                    main, feed_list=feeds, fetch_list=[spec.loss],
                    steps=FLAT_K, scope=fscope), reset)
                prof_counts = counts()
            del fexe, fscope
    finally:
        if keep is not None:
            fluid.disable_amp()
    eager_vs_eager = _state_distance(torch, eager[1][1], eager[0][1])
    replay_vs_eager = _state_distance(torch, replay[1], eager[0][1])
    replay_vs_eager_2 = _state_distance(torch, replay[1], eager[1][1])
    flat_vs_scan = _state_distance(torch, flat["flat"][1], flat["scan"][1])
    losses = {"eager_1": eager[0][0], "eager_2": eager[1][0],
              "run_steps": replay[0]}
    loss_ee = abs(eager[1][0] - eager[0][0])
    loss_re = abs(replay[0] - eager[0][0])
    want = {k: {dtype: RUN_STEPS_K * per_step, other: 0}
            for k in eager_counts}
    want_profiled = {**dict.fromkeys(PROFILED_LAUNCHES, 0),
                     **{k: FLAT_K * per_step for k in eager_counts}}
    wall, busy = long_prof["wall_s"], long_prof["busy_s"]
    kinds = long_prof["device_ms_by_kind"]
    step_med = statistics.median(step_s)
    rs_step = statistics.median(call_s) / RUN_STEPS_K
    out = {
        "enable_amp": None if keep is None else {"dtype": "bfloat16",
                                                 "keep_output": keep},
        "batch": batch, "main_ops": len(main.desc.block(0).ops),
        "losses": losses,
        "eager_vs_eager": {"max_abs": eager_vs_eager[0],
                           "not_bit_equal": len(eager_vs_eager[1]),
                           "loss": loss_ee},
        "run_steps_vs_eager": {"max_abs": replay_vs_eager[0],
                               "not_bit_equal": len(replay_vs_eager[1]),
                               "loss": loss_re,
                               "against_eager_2_max_abs":
                                   replay_vs_eager_2[0],
                               "first_names": replay_vs_eager[1][:5]},
        "flat_vs_scan": {"steps": FLAT_K, "max_abs": flat_vs_scan[0],
                         "not_bit_equal": len(flat_vs_scan[1]),
                         "losses": [flat["scan"][0], flat["flat"][0]]},
        "launches_eager_arm": eager_counts, "launches": got_counts,
        "profiled_replayed_call": {
            "steps": FLAT_K, "launches": prof["launches"],
            "counters": prof_counts, "device_records":
                prof["device_records"], "trace_head": prof["trace_head"]},
        "eager_step_ms_median": 1e3 * step_med, "eager_step_s": step_s,
        "run_steps_call_s": call_s, "run_steps_step_ms_median":
            1e3 * rs_step,
        "first_call_s": first_call_s, "capture": capture,
        "eager_profiled_step": {
            "wall_s": eager_prof["wall_s"], "busy_s": eager_prof["busy_s"],
            "busy_share": eager_prof["busy_s"] / step_med,
            "device_ms_by_kind": eager_prof["device_ms_by_kind"]},
        "run_steps_profiled_call": {
            "steps": RUN_STEPS_K, "wall_s": wall, "busy_s": busy,
            "launches": long_prof["launches"],
            "device_records": long_prof["device_records"],
            "device_records_two_step_call_scaled":
                RUN_STEPS_K // FLAT_K * prof["device_records"],
            "busy_share": busy / wall,
            "busy_ms_a_step": 1e3 * busy / RUN_STEPS_K,
            "busy_share_of_unprofiled_step":
                busy / RUN_STEPS_K / rs_step,
            "device_ms_by_kind": kinds},
        "peak_alloc_gib": {"eager": eager_peak, "run_steps": graph_peak},
        "state_copy": {"bytes": copy_bytes,
                       "bound_ms": 1e3 * copy_bytes / HBM_BYTES_PER_S,
                       "memcpy_ms_a_step": kinds.get("memcpy", 0.0)
                       / RUN_STEPS_K}}
    emit({"phase": "run_steps_path", "path": name, **out})
    if eager_counts != {k: {dtype: RUN_STEPS_K * per_step, other: 0}
                        for k in eager_counts}:
        raise AssertionError(f"{name}: eager launches {eager_counts}, want "
                             f"{per_step} a step in {dtype}")
    if got_counts != want:
        raise AssertionError(f"{name}: run_steps launches {got_counts} != "
                             f"{want}")
    if (prof["launches"] != want_profiled or prof_counts != {
            k: {dtype: FLAT_K * per_step, other: 0} for k in eager_counts}):
        raise AssertionError(f"{name}: a profiled {FLAT_K}-step call: the "
                             f"profiler saw {prof['launches']}, the "
                             f"counters read {prof_counts}; want "
                             f"{want_profiled}")
    if not (replay_vs_eager[0] <= eager_vs_eager[0] and loss_re <= loss_ee
            and (eager_vs_eager[1] or not replay_vs_eager[1])):
        raise AssertionError(f"{name}: run_steps against eager "
                             f"{out['run_steps_vs_eager']}, eager against "
                             f"eager {out['eager_vs_eager']}")
    if flat_vs_scan[1] or flat["flat"][0] != flat["scan"][0]:
        raise AssertionError(f"{name}: flat against scan "
                             f"{out['flat_vs_scan']}")
    if not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"{name}: losses not finite: {losses}")
    return out, {k: v[dtype] for k, v in got_counts.items()}


# -- phase 5b: the analysis tier -------------------------------------------

CUDA_ERROR_INVALID_VALUE = 1  # what a refused shared-memory request returns
ADD_PARITY_SHAPES = ((512, 128), (513, 128), (7, 129))
SCALE_SHAPE = (2, 4096, 4096)
SCALE_TILES = (8, 12)        # 128 KiB; 192 KiB with a ragged last tile
BOUNDARY_TILES = (14, 15)    # 229376 and 245760 bytes a block
TIMED_TILE = 8
MAIN_PATH_TILE = 14          # the main path's launch, also timed
# rows not a multiple of tile_rows and cols % 4 != 0: the element path
RAGGED_SCALE = ((3, 1000, 1001), 7)


def _refusal(_build, run, what):
    """The cudaError_t of a launch that must be refused: it fails the phase
    if the launch returns, or raises anything but KernelLaunchError with
    cudaErrorInvalidValue."""
    try:
        run()
    except _build.KernelLaunchError as e:
        if e.code != CUDA_ERROR_INVALID_VALUE:
            raise AssertionError(f"{what}: refused with cudaError_t {e.code}, "
                                 f"expected {CUDA_ERROR_INVALID_VALUE} "
                                 f"(cudaErrorInvalidValue): {e}") from e
        return e.code
    raise AssertionError(f"{what}: the launch was expected to be refused "
                         "and returned")


def _one_finding(findings, detector, what, **expect):
    if [f.detector for f in findings] != [detector]:
        raise AssertionError(f"{what}: expected exactly one {detector} "
                             f"finding, got {[f.as_dict() for f in findings]}")
    f = findings[0]
    got = {k: getattr(f, k) for k in expect}
    if f.severity != "error" or got != expect:
        raise AssertionError(f"{what}: expected an error with {expect}, got "
                             f"{f.as_dict()}")
    return f.as_dict()


def phase_analysis(torch, np):
    """The linter's kernel tier on the card: corpus_add and corpus_scale
    bit-equal to their plain versions, the card's shared-memory limit
    against the linter's budget, then (counters zeroed) the main path:
    capture and lint both corpus programs (no launch), run them through
    run_corpus_program and the captured graph, the tile_rows 14 / 15
    boundary where the linter's verdict must match what the card accepts,
    and three clean controls.  Returns (max abs errors, launches)."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import corpus as lint
    from paddle_tpu_torch.analysis.kernels import (
        detect_shared_memory_overflow)
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import corpus as ck

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 11)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32)).to(dev)

    errs = {"corpus_add": 0.0, "corpus_scale": 0.0}

    def bit_equal(got, want, what):
        """Fails unless got == want bit for bit; the largest error of each
        kernel is kept for the kernels line."""
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: not bit-equal to the plain version "
                                 f"(max abs error {err})")
        kernel = "corpus_add" if got.dim() == 2 else "corpus_scale"
        errs[kernel] = max(errs[kernel], err)

    parity = []
    for rows, cols in ADD_PARITY_SHAPES:
        x, lse = normal(rows, cols), normal(rows)
        b = lse[:, None].expand(rows, cols).contiguous()
        bit_equal(ck.corpus_add(x, b), ck.corpus_add_reference(x, b),
                  f"corpus_add [{rows}, {cols}]")
        parity.append({"kernel": "corpus_add", "shape": [rows, cols]})
    x = normal(*SCALE_SHAPE)
    want = ck.corpus_scale_reference(x)
    for tile in SCALE_TILES:
        bit_equal(ck.corpus_scale(x, tile), want,
                  f"corpus_scale tile_rows {tile}")
        parity.append({"kernel": "corpus_scale", "shape": list(SCALE_SHAPE),
                       "tile_rows": tile, "smem_bytes":
                       ck.corpus_scale_smem_bytes(x.shape, x.dtype, tile)})
    shape, tile = RAGGED_SCALE
    xr = normal(*shape)
    bit_equal(ck.corpus_scale(xr, tile), ck.corpus_scale_reference(xr),
              f"corpus_scale {list(shape)} tile_rows {tile}")
    parity.append({"kernel": "corpus_scale", "shape": list(shape),
                   "tile_rows": tile, "smem_bytes":
                   ck.corpus_scale_smem_bytes(shape, xr.dtype, tile)})
    del xr
    optin = ck.smem_per_block_optin()
    if optin != analysis.H100_SMEM_PER_BLOCK_OPTIN:
        raise AssertionError(
            f"the card's cudaDevAttrMaxSharedMemoryPerBlockOptin is {optin}, "
            f"the linter's budget {analysis.H100_SMEM_PER_BLOCK_OPTIN}")

    # the main path: capture, lint, run
    ck.reset_launches()
    arts = {name: lint.build_corpus_program(name) for name in lint.CORPUS}
    captured_launches = ck.corpus_add.launches + ck.corpus_scale.launches
    if captured_launches:
        raise AssertionError(f"capturing launched {captured_launches} kernels")
    verdicts = {
        "broadcast_lse": _one_finding(
            analysis.run_detectors(arts["broadcast_lse"]),
            "broadcast-operand", "broadcast_lse", bytes=262144),
        "vmem_overflow": _one_finding(
            analysis.run_detectors(arts["vmem_overflow"]),
            "shared-memory-overflow", "vmem_overflow",
            smem_bytes=67108864, budget=optin)}
    inputs = lint.corpus_inputs("broadcast_lse")
    out = lint.run_corpus_program("broadcast_lse")
    bit_equal(out, ck.corpus_add_reference(
        inputs[0], inputs[1][:, None].expand(512, 128)),
        "run_corpus_program('broadcast_lse')")
    bit_equal(arts["broadcast_lse"].exported.module()(*inputs), out,
              "the captured broadcast_lse graph")
    refused = {"vmem_overflow": _refusal(
        _build, lambda: lint.run_corpus_program("vmem_overflow"),
        "run_corpus_program('vmem_overflow')")}
    boundary = []
    for tile in BOUNDARY_TILES:
        art = analysis.capture_fn(lambda t: ck.corpus_scale(t, tile),
                                  analysis.TensorSpec(SCALE_SHAPE),
                                  name=f"corpus_scale_tile_{tile}")
        flagged = detect_shared_memory_overflow(art, budget=optin)
        smem = ck.corpus_scale_smem_bytes(SCALE_SHAPE, torch.float32, tile)
        if smem <= optin:
            if flagged:
                raise AssertionError(f"tile_rows {tile} ({smem} bytes) fits "
                                     f"and was flagged: {flagged}")
            bit_equal(ck.corpus_scale(x, tile), want,
                      f"corpus_scale tile_rows {tile}")
            code = 0
        else:
            _one_finding(flagged, "shared-memory-overflow",
                         f"tile_rows {tile}", smem_bytes=smem)
            code = _refusal(_build, lambda: ck.corpus_scale(x, tile),
                            f"corpus_scale tile_rows {tile}")
        boundary.append({"tile_rows": tile, "smem_bytes": smem,
                         "flagged": bool(flagged), "launched": not code,
                         "cuda_error": code})
    if [b["launched"] for b in boundary] != [True, False]:
        raise AssertionError(f"boundary: {boundary}")
    launches = {"corpus_add": ck.corpus_add.launches,
                "corpus_scale": ck.corpus_scale.launches}
    if launches != {"corpus_add": 2, "corpus_scale": 1}:
        raise AssertionError(f"main-path launches {launches}, expected 2 "
                             "corpus_add (the program and its captured "
                             "graph) and 1 corpus_scale (tile_rows 14)")

    # controls the linter must pass
    F32 = analysis.TensorSpec
    controls = {
        "add, full-size b": analysis.capture_fn(
            ck.corpus_add, F32((512, 128)), F32((512, 128))),
        "add, 32 KiB broadcast": analysis.capture_fn(
            lambda x, v: ck.corpus_add(
                x, v[:, None].expand(64, 128).contiguous()),
            F32((64, 128)), F32((64,))),
        f"scale, tile_rows {TIMED_TILE}": analysis.capture_fn(
            lambda t: ck.corpus_scale(t, TIMED_TILE), F32(SCALE_SHAPE)),
    }
    for what, art in controls.items():
        findings = analysis.run_detectors(art)
        if findings:
            raise AssertionError(f"control '{what}' was flagged: "
                                 f"{[f.as_dict() for f in findings]}")
    del x, want
    emit({"phase": "analysis", "torch": torch.__version__,
          "parity": "bit-equal", "cases": parity, "max_abs_err": errs,
          "smem_per_block_optin": optin,
          "linter_budget": analysis.H100_SMEM_PER_BLOCK_OPTIN,
          "fingerprints": {n: a.fingerprint for n, a in arts.items()},
          "verdicts": verdicts, "refused": refused, "boundary": boundary,
          "controls_clean": list(controls), "launches": launches})
    return errs, launches


# an empty kernel, launched through ctypes as the port's kernels are: the
# launch floor that row 8's time at the corpus shape is read against
EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
ADD_FLOOR_ROWS = 512 * 1024  # row 8 at [ADD_FLOOR_ROWS, 128]: bytes lead


def _empty_launch():
    """The C entry ``empty_launch(blocks, threads, stream)`` of EMPTY_SRC,
    built with the kernels' nvcc flags into the build directory."""
    import ctypes

    from paddle_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "empty_launch.cu"
    so = _build.BUILD_DIR / "libempty_launch.so"
    src.write_text(EMPTY_SRC)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(so)).empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def phase_analysis_timing(torch, np, errs, launches):
    """Row 8 (corpus_add) at the corpus shape, x [512, 128] + a materialised
    [512] broadcast, and row 9 (corpus_scale) over [2, 4096, 4096] at
    tile_rows 8, and again at 14, the main path's launch.  Bounds: each
    input read and the output written once over 3.35 TB/s.  Library calls:
    x + lse[:, None] by torch broadcasting (it reads the [512] vector, not
    the materialised operand), beside it x + b on the kernel's own
    materialised b (``library_materialised_ms``), and x * 2.  Row 8's
    launch floor beside it: an empty kernel on corpus_add's grid at the
    corpus shape, launched through ctypes and timed the same way, and
    row 8 again at [ADD_FLOOR_ROWS, 128], where its bytes, not the
    launch, lead."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import corpus as ck

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    x = torch.from_numpy(rng.standard_normal((512, 128),
                                             dtype=np.float32)).to(dev)
    lse = torch.from_numpy(rng.standard_normal(512, dtype=np.float32)).to(dev)
    b = lse[:, None].expand(512, 128).contiguous()
    src = "paddle_tpu_torch/kernels/csrc/corpus.cu"
    add = _row(
        "corpus_add", src, "paddle_tpu/analysis/corpus.py:37",
        launches["corpus_add"], errs["corpus_add"],
        device_ms(torch, lambda: ck.corpus_add(x, b)),
        device_ms(torch, lambda: ck.corpus_add_reference(x, b)),
        3 * 4 * x.numel(), x.numel(),
        device_ms(torch, lambda: x + lse[:, None]),
        {"x": [512, 128], "b": [512, 128], "library_call":
         "x + lse[:, None] (torch broadcasting)"})
    # the same function on the kernel's own operands: both [N, 128]
    add["library_materialised_ms"] = device_ms(torch, lambda: x + b)
    empty = _empty_launch()
    blocks = ck.corpus_add_grid(x.numel())[0]
    stream = torch.cuda.current_stream().cuda_stream

    def run_empty():
        _build.check(empty(blocks, ck.ADD_THREADS, stream), "empty_launch")

    add["launch_floor"] = {"empty_kernel_ms": device_ms(torch, run_empty),
                           "grid": [blocks], "threads": ck.ADD_THREADS}
    xb = torch.from_numpy(rng.standard_normal((ADD_FLOOR_ROWS, 128),
                                              dtype=np.float32)).to(dev)
    lb = torch.from_numpy(rng.standard_normal(ADD_FLOOR_ROWS,
                                              dtype=np.float32)).to(dev)
    bb = lb[:, None].expand(ADD_FLOOR_ROWS, 128).contiguous()
    if not torch.equal(ck.corpus_add(xb, bb), xb + bb):
        raise AssertionError("corpus_add at the bytes-leading size is not "
                             "bit-equal to x + b")
    add["at_bytes_leading_size"] = {
        "x": [ADD_FLOOR_ROWS, 128],
        "ms": device_ms(torch, lambda: ck.corpus_add(xb, bb)),
        "bound_ms": 1e3 * 3 * 4 * xb.numel() / HBM_BYTES_PER_S,
        "library_ms": device_ms(torch, lambda: xb + lb[:, None]),
        "library_materialised_ms": device_ms(torch, lambda: xb + bb)}
    del xb, lb, bb
    xs = torch.from_numpy(rng.standard_normal(SCALE_SHAPE,
                                              dtype=np.float32)).to(dev)
    scale = _row(
        "corpus_scale", src, "paddle_tpu/analysis/corpus.py:177",
        launches["corpus_scale"], errs["corpus_scale"],
        device_ms(torch, lambda: ck.corpus_scale(xs, TIMED_TILE)),
        device_ms(torch, lambda: ck.corpus_scale_reference(xs)),
        2 * 4 * xs.numel(), xs.numel(),
        device_ms(torch, lambda: xs * 2),
        {"x": list(SCALE_SHAPE), "tile_rows": TIMED_TILE,
         "smem_bytes": ck.corpus_scale_smem_bytes(xs.shape, xs.dtype,
                                                  TIMED_TILE),
         "library_call": "x * 2"})
    scale["at_tile_rows_14"] = {
        "tile_rows": MAIN_PATH_TILE, "grid": list(ck.corpus_scale_grid(
            SCALE_SHAPE, MAIN_PATH_TILE,
            torch.cuda.get_device_properties(dev).multi_processor_count)),
        "ms": device_ms(torch, lambda: ck.corpus_scale(xs, MAIN_PATH_TILE)),
        "bound_ms": scale["bound_ms"],
        "library_ms": device_ms(torch, lambda: xs * 2)}
    rows = [add, scale]
    emit({"phase": "analysis_timing", "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "rows": [dict(r) for r in rows]})
    for r in rows:
        r.pop("shape")
        r["launches_by_path"] = {"analysis": r["launches"]}
    return rows


# -- phase 5c: DeepFM (sparse embeddings, lazy Adam) --------------------------

# bench.py:205-216 and :309-314
DEEPFM_CFG = dict(num_fields=26, vocab_size=1000 * 1000, embed_dim=10)
DEEPFM_BATCH, DEEPFM_STEPS, DEEPFM_LR = 512, 10, 1e-3
DEEPFM_TABLES = ("deepfm_w1", "deepfm_emb")
DEEPFM_LOSS_RTOL = 1e-4  # card vs CPU loss, relative
# card vs CPU: what one step changed in each persistable (the tables'
# states at the touched rows) within this * the largest change on the CPU
DEEPFM_STATE_TOL = 2e-3
# faults planted in the card step's state, each of which must fail that
# gate: the embedding table's rows left as they were, moved the wrong way,
# or its moments those of a 1% larger gradient
DEEPFM_FAULTS = ("emb_update_skipped", "emb_update_sign_flipped",
                 "emb_moments_of_a_1pct_larger_gradient")


def build_deepfm(fluid):
    """(main, startup, spec) of DeepFM + lazy Adam, as bench.py builds
    them."""
    from paddle_tpu_torch.models import deepfm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        spec = deepfm(**DEEPFM_CFG)
        fluid.optimizer.AdamOptimizer(learning_rate=DEEPFM_LR,
                                      lazy_mode=True).minimize(spec.loss)
    return main, startup, spec


def _table_rows(name):
    """Whether persistable ``name`` has one row per id of a table (the
    table or one of its moments)."""
    return name.startswith(DEEPFM_TABLES) and "_pow_acc" not in name


def _untouched_changed(torch, state, init, untouched):
    """The table states whose rows no id touched are not all bit-equal to
    their initial values."""
    return [n for n in init if _table_rows(n)
            and not torch.equal(state[n][untouched], init[n][untouched])]


def _deepfm_fault(name, state, init):
    """``state`` with planted fault ``name`` (DEEPFM_FAULTS)."""
    out = dict(state)
    emb = DEEPFM_TABLES[1]
    if name == "emb_update_skipped":
        out[emb] = init[emb]
    elif name == "emb_update_sign_flipped":
        out[emb] = 2 * init[emb] - state[emb]
    else:  # m1 scales with the gradient, m2 with its square
        out[emb + "_moment1_0"] = state[emb + "_moment1_0"] * 1.01
        out[emb + "_moment2_0"] = state[emb + "_moment2_0"] * 1.01 ** 2
    return out


def _over_bound(state, want, init, touched):
    """{name: max |change - want's change| over DEEPFM_STATE_TOL * max
    |want's change|}, the changes from ``init`` in float64 (the tables'
    states at the touched rows); inf where want did not change and state
    did."""
    ratios = {}
    for n, t in init.items():
        a, b = state[n], want[n]
        if _table_rows(n):
            a, b, t = a[touched], b[touched], t[touched]
        got, ref = a.double() - t.double(), b.double() - t.double()
        err = float((got - ref).abs().max())
        bound = DEEPFM_STATE_TOL * float(ref.abs().max())
        ratios[n] = err / bound if bound > 0 else (
            0.0 if err == 0 else float("inf"))
    return ratios


def _worst(ratios):
    n = max(ratios, key=ratios.get)
    return {"leaf": n, "over_bound": ratios[n]}


def _deepfm_card_vs_cpu(torch, np, fluid, main, spec, init, batch, touched):
    """One step from ``init`` on the card (TF32 off, and once more with
    TF32 on) and on a CPUPlace executor: the loss's relative distance and
    each persistable's reading of _over_bound, for the sound card step,
    for each planted fault of DEEPFM_FAULTS, and for the TF32 step."""
    out = {}
    runs = (("card", fluid.Executor(), False),
            ("card_tf32", fluid.Executor(), True),
            ("cpu", fluid.Executor(fluid.CPUPlace()), False))
    for where, exe, tf32 in runs:
        scope = fluid.Scope()
        exe.load_state({n: t.clone() for n, t in init.items()}, scope)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            loss, = exe.run(main, feed=batch, fetch_list=[spec.loss],
                            scope=scope)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[where] = (float(loss.reshape(-1)[0]), {
            n: scope.find_var(n).detach().cpu() for n in init})
        del scope
    (card_loss, card), (cpu_loss, cpu) = out["card"], out["cpu"]
    ratios = _over_bound(card, cpu, init, touched)
    faults = {f: _worst(_over_bound(_deepfm_fault(f, card, init), cpu, init,
                                    touched)) for f in DEEPFM_FAULTS}
    tf32 = _worst(_over_bound(out["card_tf32"][1], cpu, init, touched))
    return {"loss_card": card_loss, "loss_cpu": cpu_loss,
            "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss),
            "state_over_bound_by_leaf": ratios, "state_worst": _worst(ratios),
            "state_over_bound": {n: r for n, r in ratios.items() if r > 1},
            "planted_faults": faults, "tf32_on": tf32}


def phase_deepfm_training(torch, np, fluid):
    """DeepFM at bench.py's width through ``Executor.run`` and
    ``Executor.run_steps`` (docstring item 5c).  Gates run after the
    phase's line is printed; each failure is printed on its own line."""
    from paddle_tpu_torch.kernels import counters

    main, startup, spec = build_deepfm(fluid)
    dev = torch.device("cuda")
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = _state_on_host(startup, scope)
    del scope
    host_batch = spec.synthetic_batch(DEEPFM_BATCH, seed=SEED)
    feed = {k: torch.from_numpy(v).to(dev) for k, v in host_batch.items()}
    ids = torch.from_numpy(np.unique(host_batch["feat_ids"]))
    untouched = torch.ones(DEEPFM_CFG["vocab_size"], dtype=torch.bool)
    untouched[ids] = False

    def loaded():
        scope = fluid.Scope()
        exe.load_state(init, scope)
        return scope

    before = counters.snapshot()
    # two eager arms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arms, step_s = [], []
    for _ in range(2):
        scope, losses = loaded(), []
        for _ in range(DEEPFM_STEPS):
            t0 = time.perf_counter()
            loss, = exe.run(main, feed=feed, fetch_list=[spec.loss],
                            scope=scope)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss.reshape(-1)[0]))
        arms.append((losses, _state_on_host(startup, scope)))
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    eager_prof = _profiled(torch, lambda: exe.run(
        main, feed=feed, fetch_list=[spec.loss], scope=scope), marks={})
    del scope
    # run_steps: captured on the first call, then replayed
    rexe, scope = fluid.Executor(), loaded()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, = rexe.run_steps(main, feed_list=[feed], fetch_list=[spec.loss],
                           steps=DEEPFM_STEPS, scope=scope)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    replay = (float(loss.reshape(-1)[0]), _state_on_host(startup, scope))
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    call_s = []
    for _ in range(RUN_STEPS_CALLS):
        t0 = time.perf_counter()
        rexe.run_steps(main, feed_list=[feed], fetch_list=[spec.loss],
                       steps=DEEPFM_STEPS, scope=scope)
        torch.cuda.synchronize()
        call_s.append(time.perf_counter() - t0)
    long_prof = _profiled(torch, lambda: rexe.run_steps(
        main, feed_list=[feed], fetch_list=[spec.loss], steps=DEEPFM_STEPS,
        scope=scope), marks={})
    capture = dict(rexe.last_capture)
    del rexe, scope
    launches = counters.difference(before, counters.snapshot())
    torch.cuda.empty_cache()
    parity = _deepfm_card_vs_cpu(torch, np, fluid, main, spec, init,
                                 host_batch, ids)

    (losses, eager), (losses_2, eager_2) = arms
    eager_vs_eager = _state_distance(torch, eager_2, eager)
    replay_vs_eager = _state_distance(torch, replay[1], eager)
    step_med = statistics.median(step_s)
    rs_step = statistics.median(call_s) / DEEPFM_STEPS
    state_bytes = sum(t.numel() * t.element_size() for t in init.values())
    kinds = long_prof["device_ms_by_kind"]
    emit({"phase": "deepfm_training", "card": card_line(),
          "config": DEEPFM_CFG, "hidden_sizes": [400, 400, 400],
          "optimizer": {"type": "adam", "lr": DEEPFM_LR, "lazy_mode": True},
          "batch": DEEPFM_BATCH, "steps": DEEPFM_STEPS,
          "main_ops": len(main.desc.block(0).ops),
          "touched_rows": int(ids.numel()), "losses": losses,
          "losses_arm_2": losses_2, "run_steps_last_loss": replay[0],
          "eager_vs_eager": {"max_abs": eager_vs_eager[0],
                             "not_bit_equal": eager_vs_eager[1][:5]},
          "run_steps_vs_eager": {"max_abs": replay_vs_eager[0],
                                 "not_bit_equal": replay_vs_eager[1][:5]},
          "card_vs_cpu": parity, "hand_written_launches": launches,
          "eager_step_ms_median": 1e3 * step_med, "eager_step_s": step_s,
          "eager_examples_per_s": DEEPFM_BATCH / step_med,
          "run_steps_call_s": call_s,
          "run_steps_step_ms_median": 1e3 * rs_step,
          "run_steps_examples_per_s": DEEPFM_BATCH / rs_step,
          "first_call_s": first_call_s, "capture": capture,
          "eager_profiled_step": {
              "wall_s": eager_prof["wall_s"], "busy_s": eager_prof["busy_s"],
              "busy_share": eager_prof["busy_s"] / step_med,
              "device_ms_by_kind": eager_prof["device_ms_by_kind"]},
          "run_steps_profiled_call": {
              "steps": DEEPFM_STEPS, "wall_s": long_prof["wall_s"],
              "busy_s": long_prof["busy_s"],
              "busy_share": long_prof["busy_s"] / long_prof["wall_s"],
              "busy_ms_a_step": 1e3 * long_prof["busy_s"] / DEEPFM_STEPS,
              "device_ms_by_kind": kinds},
          "peak_alloc_gib": {"eager": eager_peak, "run_steps": graph_peak},
          "state_copy": {"bytes": 2 * state_bytes,
                         "bound_ms": 2e3 * state_bytes / HBM_BYTES_PER_S,
                         "memcpy_ms_a_step": kinds.get("memcpy", 0.0)
                         / DEEPFM_STEPS}})
    failed = []
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failed.append(f"losses not finite and falling: {losses}")
    if eager_vs_eager[1] or losses_2 != losses:
        failed.append(f"eager arms differ: {eager_vs_eager[1][:5]}, losses "
                      f"{losses} and {losses_2}")
    if replay_vs_eager[1] or replay[0] != losses[-1]:
        failed.append(f"run_steps against eager: {replay_vs_eager[1][:5]} "
                      f"differ, last loss {replay[0]} against {losses[-1]}")
    for arm, state in (("eager", eager), ("run_steps", replay[1])):
        changed = _untouched_changed(torch, state, init, untouched)
        if changed:
            failed.append(f"{arm}: untouched rows moved in {changed}")
    if parity["loss_rel"] > DEEPFM_LOSS_RTOL or parity["state_over_bound"]:
        failed.append(f"card against CPU: loss {parity['loss_card']} and "
                      f"{parity['loss_cpu']}, state over its bound "
                      f"{parity['state_over_bound']}")
    passed = [f for f, r in list(parity["planted_faults"].items())
              + [("tf32_on", parity["tf32_on"])] if not r["over_bound"] > 1]
    if passed:
        failed.append(f"planted faults passed the card-against-CPU gate: "
                      f"{passed}")
    for f in failed:
        print(f"deepfm_training gate failed: {f}", flush=True)
    if failed:
        raise AssertionError(f"deepfm_training: {len(failed)} gates failed")


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
    # three TF32 products a multiply on the tensor cores (the FMA bound of
    # the same flops once over the fp32 peak beside it)
    f_flops = TF32_PASSES * 4 * D * pairs
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
        {"B": B, "H": H, "S": S, "D": D, "k_lengths": lens},
        TF32_FLOPS_PER_S))
    kernels[-1]["fma_bound_ms"] = 1e3 * 4 * D * pairs / FP32_FLOPS_PER_S

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
         "lengths": dlens, **_cluster_shape(pa, qd, kp, tables)}))
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
             "page_size": PAGE_SIZE, "pool": dtype, "lengths": lens,
             **_cluster_shape(pa, q, kp, tables)}))
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
    forward, 6*D dq (S, dP, dQ), 8*D dkv (S, dP, dK, dV), over the dense
    bf16 tensor peak for bf16; in fp32 as TF32_PASSES products over the
    dense TF32 tensor peak, with the FMA bound (the flops once over the
    fp32 peak) beside it as ``fma_bound_ms``.  The plain time of both
    backward rows is flash_attention_bwd_reference, which computes dQ, dK
    and dV together; so is the library call, SDPA's backward through a
    boolean mask (in the same dtype).  In fp32 the pair is timed again at
    the encoder's shape (non-causal, k_lengths from the batch's source
    rows: the encoder self-attention and the cross-attention, 12 of a
    step's 18 launches of each flash kernel), beside SDPA's backward there,
    and so is the forward with lse, beside SDPA's forward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, H, S = TRAIN_BATCH, cfg.n_head, cfg.max_length
    D = cfg.d_model // H
    scale = D ** -0.5
    dtype = torch.bfloat16 if bf16 else torch.float32
    suffix, e = ("_bf16", 2) if bf16 else ("", 4)
    peak, passes = ((BF16_FLOPS_PER_S, 1) if bf16
                    else (TF32_FLOPS_PER_S, TF32_PASSES))
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
             passes * 6 * D * pairs, sdpa_bwd, shape, peak),
        _row("flash_bwd_dkv" + suffix,
             "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
             "paddle_tpu/kernels/flash_attention.py:409",
             launches["flash_bwd_dkv"], bwd_err["flash_bwd_dkv"],
             device_ms(torch, lambda: fa.flash_bwd_dkv(
                 q, k, v, dout, lse, dvec, kl, True, scale)),
             plain_bwd, e * (4 * full + 2 * kv_rows) + 4 * (2 * rows + B),
             passes * 8 * D * pairs, sdpa_bwd, shape, peak)]
    encoder = None
    if not bf16:
        for r, flops in zip(rows_out, (6 * D * pairs, 8 * D * pairs)):
            r["fma_bound_ms"] = 1e3 * flops / FP32_FLOPS_PER_S
        src = [int(n) for n in (batch["src_word"] != cfg.pad_idx).sum(axis=1)]
        kl_src = torch.tensor(src, dtype=torch.int32, device=dev)
        enc_pairs = H * S * sum(src)
        enc_kv = H * D * sum(src)
        out_e, lse_e = fa.flash_attention_fwd(q, k, v, False, scale, kl_src)
        dvec_e = (dout * out_e).sum(dim=-1)
        mask_e = (pos[None, :] < kl_src[:, None].long())[:, None, None, :]
        qe, ke, ve = (x.clone().requires_grad_() for x in (q, k, v))
        sdpa_e = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=mask_e,
                                                scale=scale)
        encoder = {"causal": False, "k_lengths": src,
                   "library_ms": device_ms(torch, lambda: torch.autograd.grad(
                       sdpa_e, (qe, ke, ve), dout, retain_graph=True))}
        for name, fn, n_full, flops in (
                ("flash_bwd_dq", fa.flash_bwd_dq, 3, 6),
                ("flash_bwd_dkv", fa.flash_bwd_dkv, 4, 8)):
            t_bytes = 1e3 * (4 * (n_full * full + 2 * enc_kv)
                             + 4 * (2 * rows + B)) / HBM_BYTES_PER_S
            t_ops = 1e3 * TF32_PASSES * flops * D * enc_pairs / peak
            encoder[name] = {
                "ms": device_ms(torch, lambda: fn(
                    q, k, v, dout, lse_e, dvec_e, kl_src, False, scale)),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "fma_bound_ms": 1e3 * flops * D * enc_pairs
                / FP32_FLOPS_PER_S}
        t_bytes = 1e3 * (4 * (2 * full + 2 * enc_kv) + 4 * (rows + B)
                         ) / HBM_BYTES_PER_S
        t_ops = 1e3 * TF32_PASSES * 4 * D * enc_pairs / peak
        encoder["flash_fwd"] = {
            "ms": device_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, False, scale, kl_src)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "fma_bound_ms": 1e3 * 4 * D * enc_pairs / FP32_FLOPS_PER_S,
            "library_ms": device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask_e, scale=scale))}
        del qe, ke, ve, sdpa_e, out_e, lse_e, dvec_e
    fwd = _row("flash_fwd" + suffix,
               "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
               "paddle_tpu/kernels/flash_attention.py:317",
               launches["flash_fwd"], bwd_err["flash_fwd"],
               device_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, True, scale, kl)),
               device_ms(torch, lambda: fwd_plain(q, k, v, True, scale, kl)),
               e * (2 * full + 2 * kv_rows) + 4 * (rows + B),
               passes * 4 * D * pairs,
               device_ms(torch, lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, scale=scale)), shape, peak)
    if not bf16:
        fwd["fma_bound_ms"] = 1e3 * 4 * D * pairs / FP32_FLOPS_PER_S
    emit({"phase": "train_timing" + suffix,
          "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "shape": shape, "library_call": "SDPA with a boolean causal+"
          "padding mask (forward); its backward through autograd.grad, one "
          "time for dQ, dK and dV together (backward rows)",
          "plain_call": "flash_attention_bwd_reference, dQ, dK and dV "
          "together (backward rows)",
          "flash_fwd_with_lse": {k: fwd[k] for k in (
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "fma_bound_ms") if k in fwd},
          "rows": [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "fma_bound_ms") if k in r}
                   for r in rows_out],
          "encoder_noncausal": encoder})
    for r in rows_out + [fwd]:
        r.pop("shape")
    if encoder:
        for r in rows_out:
            r["encoder_noncausal"] = dict(encoder[r["name"]],
                                          library_ms=encoder["library_ms"])
        fwd["encoder_noncausal"] = encoder["flash_fwd"]
    return fwd, rows_out


SWEEP_TOKENS = 32 * 256     # B * S held at bench's 32 x 256
SWEEP_S = (256, 512, 1024, 2048)  # bench's transformer_longctx uses 2048


def phase_flash_bwd_sweep(torch):
    """The backward kernels against SDPA's backward at bench's head shape
    (H 8, D 64, causal) with B * S held at 8192 tokens and S from 256 to
    2048, every key visible up to its causal frontier: the bf16 entries on
    bf16 tensors, then the fp32 entries on fp32 tensors (SDPA in the same
    dtype, TF32 off).  SDPA's backward is timed twice: through a boolean
    causal mask (the library call of the timing rows) and with
    ``is_causal=True``.  Bounds as in phase_train_timing (fp32: bytes at 4
    bytes an element, TF32_PASSES products over the dense TF32 peak)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 11)
    H, D = 8, 64
    scale = D ** -0.5
    out_rows = {}
    for dtype, e, peak, passes in (
            (torch.bfloat16, 2, BF16_FLOPS_PER_S, 1),
            (torch.float32, 4, TF32_FLOPS_PER_S, TF32_PASSES)):
        rows = []
        for S in SWEEP_S:
            B = SWEEP_TOKENS // S
            q, k, v, dout = (torch.randn(B, H, S, D, generator=rng,
                                         device=dev).to(dtype)
                             for _ in range(4))
            kl = torch.full((B,), S, dtype=torch.int32, device=dev)
            out, lse = fa.flash_attention_fwd(q, k, v, True, scale, kl)
            dvec = (dout.float() * out.float()).sum(dim=-1)
            mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            sdpa = {}
            for how, kw in (("mask", {"attn_mask": mask}),
                            ("is_causal", {"is_causal": True})):
                qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
                o = F.scaled_dot_product_attention(qg, kg, vg, scale=scale,
                                                   **kw)
                sdpa[how] = device_ms(torch, lambda: torch.autograd.grad(
                    o, (qg, kg, vg), dout, retain_graph=True))
                del o, qg, kg, vg
            pairs = B * H * S * (S + 1) // 2
            full, rows_n = B * H * S * D, B * H * S
            bound = {kernel: 1e3 * max(
                (e * (n * full) + 4 * (2 * rows_n + B)) / HBM_BYTES_PER_S,
                passes * flops * D * pairs / peak)
                for kernel, n, flops in (("dq", 5, 6), ("dkv", 6, 8))}
            dq_ms = device_ms(torch, lambda: fa.flash_bwd_dq(
                q, k, v, dout, lse, dvec, kl, True, scale))
            dkv_ms = device_ms(torch, lambda: fa.flash_bwd_dkv(
                q, k, v, dout, lse, dvec, kl, True, scale))
            rows.append({"S": S, "B": B, "dq_ms": dq_ms, "dkv_ms": dkv_ms,
                         "sum_ms": dq_ms + dkv_ms,
                         "dq_bound_ms": bound["dq"],
                         "dkv_bound_ms": bound["dkv"],
                         "sdpa_bwd_mask_ms": sdpa["mask"],
                         "sdpa_bwd_is_causal_ms": sdpa["is_causal"]})
            del q, k, v, dout, out, lse, dvec
        name = str(dtype).removeprefix("torch.")
        emit({"phase": "flash_bwd_sweep", "card": card_line(),
              "dtype": name, "H": H, "D": D, "causal": True,
              "tokens": SWEEP_TOKENS, "method": "CUDA events, median of 30 "
              "after 5 warm-up calls, queued behind torch.cuda._sleep",
              "rows": rows})
        out_rows[name] = rows
    return out_rows


def phase_flash_fwd_sweep(torch):
    """The forward (with lse) against SDPA's forward at bench's head shape
    (H 8, D 64, causal) with B * S held at 8192 tokens and S from 256 to
    2048, every key visible up to its causal frontier: the bf16 entry on
    bf16 tensors, then the fp32 entry on fp32 tensors (SDPA in the same
    dtype, TF32 off).  SDPA is timed through a boolean causal mask (the
    library call of the timing rows) and with ``is_causal=True``.  Bound:
    Q, K, V read and O written once at the element size, lse at 4 bytes;
    4*D flops per visible pair over the dense bf16 peak, or TF32_PASSES
    times that over the dense TF32 peak (fp32, with the FMA bound beside
    it)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev).manual_seed(SEED + 13)
    H, D = 8, 64
    scale = D ** -0.5
    out_rows = {}
    for dtype, e, peak, passes in (
            (torch.bfloat16, 2, BF16_FLOPS_PER_S, 1),
            (torch.float32, 4, TF32_FLOPS_PER_S, TF32_PASSES)):
        rows = []
        for S in SWEEP_S:
            B = SWEEP_TOKENS // S
            q, k, v = (torch.randn(B, H, S, D, generator=rng, device=dev)
                       .to(dtype) for _ in range(3))
            kl = torch.full((B,), S, dtype=torch.int32, device=dev)
            mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            pairs = B * H * S * (S + 1) // 2
            full = B * H * S * D
            row = {
                "S": S, "B": B,
                "fwd_ms": device_ms(torch, lambda: fa.flash_attention_fwd(
                    q, k, v, True, scale, kl)),
                "bound_ms": 1e3 * max((e * 4 * full + 4 * B * H * S)
                                      / HBM_BYTES_PER_S,
                                      passes * 4 * D * pairs / peak),
                "sdpa_mask_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=scale)),
                "sdpa_is_causal_ms": device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale))}
            if dtype == torch.float32:
                row["fma_bound_ms"] = 1e3 * 4 * D * pairs / FP32_FLOPS_PER_S
            rows.append(row)
            del q, k, v
        name = str(dtype).removeprefix("torch.")
        emit({"phase": "flash_fwd_sweep", "card": card_line(),
              "dtype": name, "H": H, "D": D, "causal": True,
              "tokens": SWEEP_TOKENS, "method": "CUDA events, median of 30 "
              "after 5 warm-up calls, queued behind torch.cuda._sleep",
              "rows": rows})
        out_rows[name] = rows
    return out_rows


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


def phase_conv_stats_sweep(torch, fluid):
    """conv_stats at every distinct conv shape of ResNet-50 at the main
    path's batch, in fp32 and bf16: kernel ms, the library call's ms
    (F.conv2d + torch.var_mean: cuDNN with TF32 off in fp32, bf16 on
    channels-last tensors), the bound and the program's launches a step;
    then each column summed over a step, weighted by those launches."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import conv_epilogue as ce

    dev = torch.device("cuda")
    cl = torch.channels_last
    rng = torch.Generator(device=dev).manual_seed(SEED + 14)
    per_step = {}
    for key, n in conv_classes(build_resnet(fluid)[0], RESNET_BATCH).items():
        per_step[key[:8]] = per_step.get(key[:8], 0) + n
    rows = []
    sums = {d: {"kernel_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
            for d in ("float32", "bfloat16")}
    for key in sorted(per_step):
        N, H, W, C, Fo, K, s, p = key
        x, w, _, _ = _conv_inputs(torch, rng, N, H, W, C, Fo, K, dev)
        row = {"shape": [N, H, W, C, Fo, K, s, p],
               "launches_per_step": per_step[key]}
        for dtype, peak in ((torch.float32, FP32_FLOPS_PER_S),
                            (torch.bfloat16, BF16_FLOPS_PER_S)):
            xd, wd = x.to(dtype), w.to(dtype)
            xn = xd.permute(0, 3, 1, 2)  # NCHW-shaped, channels-last memory
            wn = wd.permute(3, 2, 0, 1).contiguous(memory_format=cl)
            nbytes, flops = _conv_stats_work(N, H, W, C, Fo, K, s, p,
                                             itemsize=dtype.itemsize)
            name = str(dtype).removeprefix("torch.")
            r = {"kernel_ms": device_ms(
                     torch, lambda: ce.conv_stats(xd, wd, s, p)),
                 "library_ms": device_ms(torch, lambda: torch.var_mean(
                     F.conv2d(xn, wn, stride=s, padding=p), dim=(0, 2, 3),
                     unbiased=False)),
                 "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                       flops / peak),
                 "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                              >= flops / peak else "operations")}
            for k in sums[name]:
                sums[name][k] += per_step[key] * r[k]
            row[name] = r
            del xd, wd, xn, wn
        rows.append(row)
        del x, w
    torch.cuda.empty_cache()
    emit({"phase": "conv_stats_sweep", "card": card_line(),
          "batch": RESNET_BATCH, "method": "CUDA events, median of 30 "
          "after 5 warm-up calls, queued behind torch.cuda._sleep",
          "library_call": "F.conv2d + torch.var_mean (fp32: TF32 off; "
                          "bf16: channels-last)",
          "rows": rows, "per_step_weighted_ms": sums})
    return sums


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
    bf16p_err = phase_bf16_paged_parity(torch)
    phase_cluster_parity(torch)
    bwd_err = phase_bwd_parity(torch)
    bf16_err = phase_bf16_parity(torch)
    conv_err = phase_conv_parity(torch, fluid)
    conv_bf16_err = phase_conv_parity_bf16(torch, fluid)
    serve_launches, reqs = phase_main_path(torch, np)
    spec_launches, spec_reqs = phase_spec_main_path(torch, np)
    sampled_launches = phase_sampled_serving(torch, np)
    lc_launches = phase_longctx(torch, np)
    lc_bf16_launches = phase_longctx_bf16(torch, np)
    prefix_launches = phase_prefix_serving(torch, np)
    train_launches, batch, cfg = phase_training(torch, np)
    torch.cuda.empty_cache()
    amp_launches, amp_batch, amp_cfg = phase_amp_training(torch, np)
    torch.cuda.empty_cache()
    conv_launches, by_shape, trace = phase_resnet(torch, np, fluid)
    torch.cuda.empty_cache()
    resnet_amp_launches = phase_resnet_amp(torch, np, fluid)
    torch.cuda.empty_cache()
    rs_launches = phase_run_steps_training(torch, np, fluid)
    analysis_err, analysis_launches = phase_analysis(torch, np)
    torch.cuda.empty_cache()
    phase_deepfm_training(torch, np, fluid)
    torch.cuda.empty_cache()
    kernels = phase_timing(torch, np, reqs, parity_err, serve_launches)
    spec_rows = phase_spec_timing(torch, np, spec_reqs, spec_err,
                                  spec_launches)
    for r in spec_rows:  # verify_f32, decode_i8, verify_i8
        variant = r["name"].removeprefix("paged_")
        r["launches_by_path"] = {
            "int8_serving" if variant.endswith("i8")
            else "speculative_serving": r["launches"],
            **{path: n[variant] for path, n in sampled_launches.items()}}
        r["launches"] = sum(r["launches_by_path"].values())
    kernels += spec_rows
    lc_rows, lc_flat = phase_longctx_timing(torch, np, lc_err, lc_launches)
    kernels += lc_rows
    bf16_rows = phase_bf16_paged_timing(
        torch, np, reqs, spec_reqs, bf16p_err,
        {"prefix": prefix_launches, "longctx": lc_bf16_launches})
    for r, key in zip(bf16_rows[:2], ("decode_bf16", "verify_bf16")):
        r["launches_by_path"] = {"shared_prefix_" + run: v[key]
                                 for run, v in prefix_launches.items()
                                 if v[key]}
    kernels += bf16_rows
    # the fp32 backward rows run in the fp32 phase and under amp1
    fp32_bwd_launches = {k: train_launches[k] + amp_launches["amp1"][k]
                         for k in FLASH_KERNELS}
    fp32_fwd, bwd_rows = phase_train_timing(torch, bwd_err,
                                            fp32_bwd_launches, cfg, batch)
    for r in bwd_rows:
        kernel = r["name"]
        r["launches_by_path"] = {"training": train_launches[kernel],
                                 "training_amp1": amp_launches["amp1"][kernel]}
    kernels += bwd_rows
    bf16_fwd, bf16_bwd = phase_train_timing(
        torch, bf16_err, amp_launches["keep"], amp_cfg, amp_batch, bf16=True)
    phase_flash_fwd_sweep(torch)
    phase_flash_bwd_sweep(torch)
    for r in [bf16_fwd] + bf16_bwd:
        r["launches_by_path"] = {"training_amp_keep": r["launches"]}
    kernels += [bf16_fwd] + bf16_bwd
    kernels += phase_conv_timing(torch, conv_err, conv_launches, by_shape,
                                 trace)
    conv_bf16_rows = phase_conv_timing_bf16(torch, conv_bf16_err,
                                            resnet_amp_launches)
    kernels += conv_bf16_rows
    # the run_steps paths' launches (replayed graphs) beside the eager ones
    for path, rows in (("transformer_fp32", bwd_rows),
                       ("transformer_keep", [bf16_fwd] + bf16_bwd),
                       ("resnet_keep", conv_bf16_rows)):
        for r in rows:
            n = rs_launches[path][r["name"].removesuffix("_bf16")]
            r["launches_by_path"]["run_steps_" + path] = n
            r["launches"] += n
    phase_conv_stats_sweep(torch, fluid)
    kernels += phase_analysis_timing(torch, np, analysis_err,
                                     analysis_launches)
    # flash_fwd runs on every path and paged_decode on both fp32 serving
    # paths: their launches are the counted runs' sums
    by_path = {"serving": serve_launches["flash_fwd"],
               "speculative_serving": spec_launches["spec"]["flash_fwd"],
               "int8_serving": spec_launches["int8"]["flash_fwd"],
               **{path: n["flash_fwd"]
                  for path, n in sampled_launches.items()},
               "long_context_serving": sum(
                   a["flash_fwd"] for a in lc_launches.values()),
               "training": train_launches["flash_fwd"],
               "training_amp1": amp_launches["amp1"]["flash_fwd"],
               "run_steps_transformer_fp32":
                   rs_launches["transformer_fp32"]["flash_fwd"]}
    kernels[0]["launches"] = sum(by_path.values())
    kernels[0]["launches_by_path"] = by_path
    kernels[0]["max_abs_err"] = max(parity_err["flash_fwd"],
                                    bwd_err["flash_fwd"])
    # the fp32 forward with lse at the training shapes (phase train_timing)
    kernels[0]["training_with_lse"] = {k: fp32_fwd[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "fma_bound_ms",
        "library_ms", "encoder_noncausal")}
    by_path = {"serving": serve_launches["paged_decode"],
               "speculative_serving": spec_launches["spec"]["decode_f32"],
               **{path: n["decode_f32"]
                  for path, n in sampled_launches.items()},
               "long_context_no_window":
                   lc_launches["no_window"]["by_variant"]["decode_f32"],
               "shared_prefix_fp32_cache":
                   prefix_launches["fp32_cache"]["decode_f32"]}
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
