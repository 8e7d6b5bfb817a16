"""The arithmetic of the conv_stats kernels' tile walk, on the CPU.

``paddle_tpu_torch/kernels/csrc/conv_epilogue.cu`` computes conv_stats as
an implicit GEMM: a block owns 128 rows of M = N * Ho * Wo, builds its A
tile chunk by chunk from NHWC x (row m is the pixel (n, ho, wo); column k
the tap (kh, kw) and channel c; zero where the pixel lies outside the image
or the row past M), multiplies in fp32 and rounds ``out`` once to x's
dtype, and takes each tile's partial sum and sum of squares from the
unrounded accumulators (``_stats_update``,
``paddle_tpu/kernels/conv_epilogue.py:140``, ``:147-148``).  One or two
more kernels reduce the partial rows in a fixed order.  bf16 chunks are 64
deep in tap order where C % 8 == 0; otherwise (the stem, C = 3) the
block first copies the input rows its taps reach into a window with zero
halo columns, and the reduction runs kh by kh, each kh's K * C values
padded with zero weights to a multiple of 8.  fp32 chunks are 16 deep.

``tile_model`` below is a plain model of exactly that walk, written here
and nowhere else.  It is held against the port's ``conv_stats_reference``
and against the JAX ``conv_bn_act(interpret=True, return_conv=True)`` on
3x3/1 pad 1, 3x3/2 pad 1, 1x1/1, 1x1/2 and 7x7/2 pad 3 with C = 3, M off
the 128-row tile, F = 72, C = 24 at 3x3 (K*K*C off both chunks) and an odd
C whose rows are not whole 16-byte units, in both dtypes, under the gates
of test_torch_conv_epilogue.py and test_torch_resnet_amp.py: fp32 out
within 1e-4 * max(1, max |plain|), the sums (and mean, var) within 1e-5
of the vector's largest; bf16 out within 2^-7 * max |plain| with at most
1% of the elements not bit-equal.

Four planted variants must FAIL: a halo read clamped to the edge pixel
instead of zero, the stem's window one input row short, the stride left
out of the gather, and bf16 sums taken from the rounded ``out`` (at M <=
4096, where the share gate of chip_smoke.py is required to see it too).
The stem kernel's window is sized by ``window_rows`` and its rows are not
counted again on the card, so that bound is held against every tile's rows.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jce = importlib.import_module("paddle_tpu.kernels.conv_epilogue")

from paddle_tpu_torch.kernels import conv_epilogue as tce  # noqa: E402

TILE_M = 128     # output rows a block
BF16_CHUNK = 64  # bf16 reduction chunk (a 128-byte row of A)
F32_CHUNK = 16   # fp32 reduction chunk
REDUCE_LANES = 32  # stats_reduce_kernel's row lanes
SEGMENT = 256      # partial rows a first-pass block sums (T > SEGMENT)
SEGMENT_LANES = 8  # its row lanes
BF16_ULP = 2.0 ** -7
MISMATCH_SHARE = 0.01
FP32_TOL = 1e-4
STATS_RTOL = 1e-5
ROUNDED_STATS_GATED_M = 4096

# (N, H, W, C, F, K, stride, padding)
CASES = {
    "3x3s1p1": (2, 10, 10, 16, 24, 3, 1, 1),       # M 200: off the tile
    "3x3s2p1": (2, 12, 12, 16, 16, 3, 2, 1),
    "1x1s1": (2, 8, 8, 32, 16, 1, 1, 0),           # M 128: one whole tile
    "1x1s2": (3, 10, 10, 16, 32, 1, 2, 0),
    "stem_7x7s2p3_c3": (2, 20, 20, 3, 16, 7, 2, 3),
    "3x3s1p1_f72": (2, 9, 9, 16, 72, 3, 1, 1),
    "3x3s1p1_c24": (2, 9, 9, 24, 16, 3, 1, 1),     # K*K*C 216
    "3x3s1p1_c5_odd_rows": (1, 13, 11, 5, 8, 3, 1, 1),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the cases each planted variant must fail on
HALO_CASES = ("3x3s1p1", "3x3s2p1", "stem_7x7s2p3_c3", "3x3s1p1_c24")
STRIDE_CASES = ("3x3s2p1", "1x1s2", "stem_7x7s2p3_c3")


def _geometry(N, H, W, C, F, K, s, p):
    Ho, Wo = (H + 2 * p - K) // s + 1, (W + 2 * p - K) // s + 1
    return Ho, Wo, N * Ho * Wo


def _inputs(case, dtype, seed=0):
    N, H, W, C, F, K, s, p = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.random((N, H, W, C), dtype=np.float32)  # post-ReLU-like
    w = (rng.standard_normal((K, K, C, F)) * (2.0 / (K * K * C)) ** 0.5
         ).astype(np.float32)
    return (torch.from_numpy(x).to(DTYPES[dtype]),
            torch.from_numpy(w).to(DTYPES[dtype]))


def _window(x, K, s, p, rows, *, short=False, clamp=False):
    """The bf16 kernel's window of one tile (C % 8 != 0): the flattened
    input rows from the first row's top tap to the last row's bottom tap,
    each with p zero halo columns on both sides (as [rows, W + 2p, C]),
    and the first flattened row.  ``short`` drops the bottom row (a planted
    fault); ``clamp`` fills the halo with the edge pixels (another)."""
    N, H, W, C = x.shape
    n, hi0 = rows[0][0], rows[0][1]
    n1, hi1 = rows[-1][0], rows[-1][1]
    r_lo = n * H + max(0, hi0)
    r_hi = n1 * H + min(H - 1, hi1 + K - 1)
    flat = x.float().reshape(N * H, W, C)[r_lo:r_hi + 1 - int(short)]
    if clamp:
        win = torch.cat([flat[:, :1].expand(-1, p, -1), flat,
                         flat[:, -1:].expand(-1, p, -1)], dim=1)
    else:
        win = torch.nn.functional.pad(flat, (0, 0, p, p))
    return win, r_lo


def tile_model(x, w, stride, padding, *, clamp_halo=False,
               window_short=False, no_stride=False, rounded_sums=False):
    """(out, sum, sumsq) of conv_stats as the kernels compute it, tile by
    tile and chunk by chunk: x [N, H, W, C] and w [K, K, C, F] in fp32 or
    bf16.  The planted faults: ``clamp_halo`` reads the edge pixel for a
    tap outside the image, ``window_short`` leaves the window's bottom row
    out (bf16, C % 8 != 0), ``no_stride`` gathers pixel (ho - p, wo - p),
    ``rounded_sums`` takes the sums from the rounded out."""
    N, H, W, C = x.shape
    K, _, _, F = w.shape
    s, p = stride, padding
    Ho, Wo, M = _geometry(N, H, W, C, F, K, s, p)
    bf16 = x.dtype == torch.bfloat16
    runs = bf16 and C % 8 != 0   # the window walk, kh by kh
    KC = K * C
    KCP = -(-KC // 8) * 8
    chunk = BF16_CHUNK if bf16 else F32_CHUNK
    kred = K * KCP if runs else K * K * C
    nch = -(-kred // chunk)
    # B: w's row for each reduction index, zero rows past the reduction
    wf = w.float().reshape(K * K * C, F)
    k = torch.arange(nch * chunk)
    if runs:
        kh, j = k // KCP, k % KCP
        src = torch.where((kh < K) & (j < KC), kh * KC + j, -1)
    else:
        src = torch.where(k < K * K * C, k, -1)
    B = torch.where((src >= 0)[:, None], wf[src.clamp(min=0)], 0.0)
    xf = x.float()
    step = 1 if no_stride else s
    out = torch.zeros(-(-M // TILE_M) * TILE_M, F)
    part_s, part_q = [], []
    for t0 in range(0, M, TILE_M):
        m = torch.arange(t0, t0 + TILE_M)
        live = m < M
        mm = torch.where(live, m, 0)
        n, ho, wo = mm // (Ho * Wo), (mm % (Ho * Wo)) // Wo, mm % Wo
        hi0 = torch.where(live, ho * step - p, -(1 << 30))
        wi0 = wo * step - p
        if runs:
            rows = [(int(n[i]), int(hi0[i])) for i in (0, int(live.sum()) - 1)]
            win, r_lo = _window(x, K, s, p, rows, short=window_short,
                                clamp=clamp_halo)
            kh, j = k // KCP, k % KCP
            kw, c = j // C, j % C
            hi = hi0[:, None] + kh[None, :]
            wrow = n[:, None] * H + hi - r_lo
            ok = ((kh < K) & (j < KC))[None, :] & (hi >= 0) & (hi < H)
            ok = ok & (wrow < win.shape[0])   # (a short window reads zeros)
            col = (wi0[:, None] + p + kw[None, :]).clamp(0, W + 2 * p - 1)
            A = torch.where(ok, win[wrow.clamp(0, win.shape[0] - 1), col,
                                    c[None, :].expand(TILE_M, -1)], 0.0)
        else:
            tap, c = k // C, k % C
            kh, kw = tap // K, tap % K
            hi = hi0[:, None] + kh[None, :]
            wi = wi0[:, None] + kw[None, :]
            inside = (hi >= 0) & (hi < H) & (wi >= 0) & (wi < W)
            ok = (k < K * K * C)[None, :] & live[:, None]
            if not clamp_halo:
                ok = ok & inside
            A = torch.where(ok, xf[n[:, None].expand(-1, k.numel()),
                                   hi.clamp(0, H - 1), wi.clamp(0, W - 1),
                                   c[None, :].expand(TILE_M, -1)], 0.0)
        acc = torch.zeros(TILE_M, F)
        for c0 in range(0, nch * chunk, chunk):   # the chunk walk
            acc = acc + A[:, c0:c0 + chunk] @ B[c0:c0 + chunk]
        out[t0:t0 + TILE_M] = acc
        stat = acc.to(x.dtype).float() if rounded_sums else acc
        part_s.append(stat.sum(0))
        part_q.append((stat * stat).sum(0))
    ssum, ssq = (_reduce(torch.stack(part)) for part in (part_s, part_q))
    return (out[:M].to(x.dtype).reshape(N, Ho, Wo, F), ssum, ssq)


def _reduce(part):
    """The kernels' order over the [T, F] partial rows, fp32 throughout:
    where T > SEGMENT, segment g's rows g SEGMENT .. first (lane y of 8
    adds rows y, y + 8, ...; then the lanes in order), then
    stats_reduce_kernel over the T rows (or the segments' sums): lane l of
    32 adds rows l, l + 64, ... into one sum and l + 32, l + 96, ... into
    another, then lane 0 adds the lanes' totals in lane order."""
    part = part.numpy().astype(np.float32)
    if part.shape[0] > SEGMENT:
        segs = []
        for r0 in range(0, part.shape[0], SEGMENT):
            seg = part[r0:r0 + SEGMENT]
            lanes = []
            for lane in range(SEGMENT_LANES):
                s = np.zeros(part.shape[1], np.float32)
                for r in range(lane, seg.shape[0], SEGMENT_LANES):
                    s = s + seg[r]
                lanes.append(s)
            total = np.zeros(part.shape[1], np.float32)
            for v in lanes:
                total = total + v
            segs.append(total)
        part = np.stack(segs)
    T = part.shape[0]
    lanes = []
    for lane in range(REDUCE_LANES):
        s0 = np.zeros(part.shape[1], np.float32)
        s1 = np.zeros(part.shape[1], np.float32)
        r = lane
        while r + 32 < T:
            s0 = s0 + part[r]
            s1 = s1 + part[r + 32]
            r += 64
        if r < T:
            s0 = s0 + part[r]
        lanes.append(s0 + s1)
    total = np.zeros(part.shape[1], np.float32)
    for v in lanes:
        total = total + v
    return torch.from_numpy(total)


def _stats(out, ssum, ssq):
    return tce._batch_stats(out, ssum, ssq)


@functools.lru_cache(maxsize=None)
def _jax_run(case, dtype):
    """JAX conv_bn_act with its Pallas kernels in interpret mode: (out,
    mean, var) as numpy fp32."""
    x, w = _inputs(case, dtype)
    N, H, W, C, F, K, s, p = CASES[case]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x.float().numpy()).astype(jd)
    wj = jnp.asarray(w.float().numpy()).astype(jd)
    ones, zeros = jnp.ones((F,), jnp.float32), jnp.zeros((F,), jnp.float32)
    _, mean, var, out = jce.conv_bn_act(xj, wj, ones, zeros, None, stride=s,
                                        padding=p, act="", interpret=True,
                                        return_conv=True)
    return tuple(np.array(a.astype(jnp.float32)) for a in (out, mean, var))


def _out_ok(got, want, dtype):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    if dtype == "float32":
        return err <= FP32_TOL * max(1.0, float(want.abs().max()))
    share = float((got != want).float().mean())
    return err <= BF16_ULP * float(want.abs().max()) and share <= \
        MISMATCH_SHARE


def _vec_ok(got, want):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    return float((got - want).abs().max()) <= STATS_RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_tile_model_matches_the_plain_version(case, dtype):
    x, w = _inputs(case, dtype)
    _, _, _, _, _, _, s, p = CASES[case]
    out, ssum, ssq = tile_model(x, w, s, p)
    pout, psum, pssq = tce.conv_stats_reference(x, w, s, p)
    assert out.dtype == pout.dtype and out.shape == pout.shape
    assert _out_ok(out, pout, dtype)
    assert _vec_ok(ssum, psum) and _vec_ok(ssq, pssq)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_tile_model_matches_the_pallas_kernel(case, dtype):
    x, w = _inputs(case, dtype)
    _, _, _, _, _, _, s, p = CASES[case]
    out, ssum, ssq = tile_model(x, w, s, p)
    jout, jmean, jvar = _jax_run(case, dtype)
    mean, var = _stats(out, ssum, ssq)
    assert _out_ok(out, torch.from_numpy(jout).to(out.dtype), dtype)
    assert _vec_ok(mean, jmean) and _vec_ok(var, jvar)


def _fails(case, dtype, **fault):
    """Whether the planted variant misses a gate against the plain
    version: out's, or (for the sums) mean's and var's."""
    x, w = _inputs(case, dtype)
    _, _, _, _, _, _, s, p = CASES[case]
    out, ssum, ssq = tile_model(x, w, s, p, **fault)
    pout, psum, pssq = tce.conv_stats_reference(x, w, s, p)
    mean, var = _stats(out, ssum, ssq)
    pmean, pvar = _stats(pout, psum, pssq)
    return not (_out_ok(out, pout, dtype) and _vec_ok(mean, pmean)
                and _vec_ok(var, pvar))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_clamped_to_the_edge_fails(case, dtype):
    assert _fails(case, dtype, clamp_halo=True)


def test_stem_window_one_row_short_fails():
    assert _fails("stem_7x7s2p3_c3", "bfloat16", window_short=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", STRIDE_CASES)
def test_stride_left_out_of_the_gather_fails(case, dtype):
    assert _fails(case, dtype, no_stride=True)


@pytest.mark.parametrize("case", [c for c in CASES if _geometry(
    *CASES[c])[2] <= ROUNDED_STATS_GATED_M])
def test_bf16_sums_from_the_rounded_out_fail(case):
    assert _fails(case, "bfloat16", rounded_sums=True)


@pytest.mark.parametrize("T", [1, 31, 256, 257, 600])
def test_partial_row_reduction_order_sums_the_rows(T):
    """The two-pass order over T partial rows (one pass up to SEGMENT)
    against float64 sums of the same rows."""
    rng = np.random.default_rng(T)
    part = rng.standard_normal((T, 5)).astype(np.float32)
    got = _reduce(torch.from_numpy(part)).double().numpy()
    want = part.astype(np.float64).sum(axis=0)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


def test_fp32_model_without_faults_is_the_plain_conv_in_float64():
    """The walk itself (tiles, chunks, zero fill, the reduction) on
    float64 values: the fp32 model against the float64 plain version."""
    x, w = _inputs("stem_7x7s2p3_c3", "float32")
    out, ssum, ssq = tile_model(x, w, 2, 3)
    pout, psum, pssq = tce.conv_stats_reference(x.double(), w.double(), 2, 3)
    assert float((out.double() - pout).abs().max()) <= 1e-5 * float(
        pout.abs().max())
    assert _vec_ok(ssum.double(), psum) and _vec_ok(ssq.double(), pssq)


def _window_rows(N, H, W, C, K, s, p, Ho, Wo):
    """``window_rows`` of csrc/conv_epilogue.cu without its 64 KB cap: the
    input rows the stem kernel's window holds, for any tile.  Its rows span
    at most Q = ceil(127 / Wo) output-row steps."""
    Q = -(-(TILE_M - 1) // Wo)
    two = 2 * K - 2 * p - 1
    rows = Q * s + max(two, K) if Q < Ho else (Q // Ho + 2) * H
    return min(rows, N * H)


# (N, H, W, C, F, K, stride, padding) of C % 8 != 0 convs
WINDOW_GEOMETRIES = {
    "stem_b256": (256, 224, 224, 3, 64, 7, 2, 3),
    "stem_small": CASES["stem_7x7s2p3_c3"],
    "odd_rows": CASES["3x3s1p1_c5_odd_rows"],
    "narrow_w": (3, 40, 5, 3, 8, 3, 1, 1),      # several images a tile
    "k5_s3": (2, 9, 30, 3, 8, 5, 3, 0),
    "pad_past_half": (2, 11, 13, 3, 8, 3, 1, 2),
    "one_row_images": (9, 1, 7, 3, 8, 1, 1, 0),
}


@pytest.mark.parametrize("geom", list(WINDOW_GEOMETRIES))
def test_window_rows_bounds_every_tile(geom):
    """The stem kernel copies each tile's input rows, from its first row's
    top tap to its last row's bottom tap, into a window of window_rows rows
    and does not count them again: every tile's rows must fit."""
    N, H, W, C, F, K, s, p = WINDOW_GEOMETRIES[geom]
    Ho, Wo, M = _geometry(N, H, W, C, F, K, s, p)
    first = np.arange(0, M, TILE_M)
    last = np.minimum(first + TILE_M, M) - 1
    n0, ho0 = first // (Ho * Wo), first % (Ho * Wo) // Wo
    n1, ho1 = last // (Ho * Wo), last % (Ho * Wo) // Wo
    r_lo = n0 * H + np.maximum(0, ho0 * s - p)
    nrows = n1 * H + np.minimum(H - 1, ho1 * s - p + K - 1) + 1 - r_lo
    assert nrows.max() <= _window_rows(N, H, W, C, K, s, p, Ho, Wo)
