"""The launch shape of ``corpus_scale`` (kernel row 9), on the CPU.

``csrc/corpus.cu`` runs ``corpus_scale_f32`` on the grid that
``corpus_scale_grid`` gives: at most one block an SM, each block walking
tiles y, y + grid_y, ... of its matrix through a shared-memory buffer of
exactly ``corpus_scale_smem_bytes``.  Where rows are 16-byte multiples
the stream kernel cuts each tile into chunks that pass through eight
slots of the buffer (``chunk_plan`` below models that arithmetic: the
kernel's lines, written here again), and the linter prices the launch
with the same grid function, so its verdict and the card's launch cannot
drift.  The kernels themselves run only on the card (``chip_smoke.py``
holds them bit-equal to x * 2).
"""

import itertools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from paddle_tpu_torch import analysis  # noqa: E402
from paddle_tpu_torch.analysis import kernels as akernels  # noqa: E402
from paddle_tpu_torch.kernels import corpus as ck  # noqa: E402

SLOTS, ALIGN, HEADER = 8, 128, 128  # csrc/corpus.cu
SHAPES = [(2, 4096, 4096), (1, 4096, 4096), (3, 1000, 1001), (200, 17, 64),
          (1, 1, 4), (132, 64, 256), (7, 33, 12)]


def cdiv(a, b):
    return -(-a // b)


def chunk_plan(shape, tile_rows, buf_bytes):
    """(chunk, slot): the bytes of the stream kernel's chunks of a tile
    and of one of its slots, as corpus_scale_stream_kernel computes them."""
    _, _, cols = shape
    slot = (buf_bytes - HEADER) // SLOTS // ALIGN * ALIGN
    full = tile_rows * 4 * cols
    per_tile = cdiv(full, slot)
    return cdiv(cdiv(full, per_tile), ALIGN) * ALIGN, slot


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_holds_one_block_an_sm_and_walks_every_tile(shape):
    n_blocks, rows, _ = shape
    for tile_rows, sms in itertools.product((1, 3, 8, 14, 4096), (132, 7)):
        gx, gy = ck.corpus_scale_grid(shape, tile_rows, sms)
        tiles = cdiv(rows, tile_rows)
        assert gx == n_blocks and 1 <= gy <= tiles
        # at most one block an SM, unless the matrices alone outnumber them
        assert gx * gy <= max(sms, n_blocks)
        # and no SM left out that a tile could have used
        assert gy == tiles or gx * (gy + 1) > sms
        walked = sorted(t for y in range(gy) for t in range(y, tiles, gy))
        assert walked == list(range(tiles))  # each tile once


def test_vmem_overflow_grid_is_one_block_a_matrix():
    assert ck.corpus_scale_grid((2, 4096, 4096), 4096) == (2, 1)
    assert ck.corpus_scale_grid((2, 4096, 4096), 8) == (2, 66)
    assert ck.corpus_scale_grid((2, 4096, 4096), 14) == (2, 66)


@pytest.mark.parametrize("tile_rows", [8, 14])
def test_linter_prices_the_wrappers_grid(tile_rows):
    art = analysis.capture_fn(lambda t: ck.corpus_scale(t, tile_rows),
                              analysis.TensorSpec((2, 4096, 4096)))
    (node,) = akernels.iter_kernel_calls(art.graph)
    cost = analysis.kernel_cost(node)
    assert cost.grid == ck.corpus_scale_grid((2, 4096, 4096), tile_rows,
                                             ck.H100_SMS)
    assert cost.smem_bytes == ck.corpus_scale_smem_bytes(
        (2, 4096, 4096), torch.float32, tile_rows)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[2] % 4 == 0])
def test_stream_chunks_fit_their_slots_and_cover_each_tile(shape):
    """Where the stream kernel runs (16-byte rows and a buffer of eight
    128-byte slots at least), a tile's chunks are 128-byte multiples but
    the last, each within a slot, and they cover the tile once."""
    _, rows, cols = shape
    for tile_rows in range(1, 20):
        buf = ck.corpus_scale_smem_bytes(shape, torch.float32, tile_rows)
        if buf < HEADER + SLOTS * ALIGN:
            continue  # the element path
        chunk, slot = chunk_plan(shape, tile_rows, buf)
        assert chunk % ALIGN == 0 and 0 < chunk <= slot
        assert HEADER + SLOTS * chunk <= buf
        for r0 in range(0, rows, tile_rows):
            nbytes = min(tile_rows, rows - r0) * 4 * cols
            pieces = [min(chunk, nbytes - off)
                      for off in range(0, nbytes, chunk)]
            assert sum(pieces) == nbytes
            assert all(p > 0 and p % 16 == 0 for p in pieces)
