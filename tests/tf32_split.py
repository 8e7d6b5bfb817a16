"""The split-TF32 arithmetic of the fp32 flash kernels, on the CPU.

``paddle_tpu_torch/kernels/csrc/tf32_split.cuh`` holds what the fp32
forward (csrc/flash_fwd.cu) and backward (csrc/flash_bwd.cu) kernels
share: every fp32 operand x is split as big = tf32(x) and small =
tf32(x - big), tf32() rounding to nearest with ties away from zero at 10
mantissa bits (what ``cvt.rna.tf32.f32`` does), and each product sums
small·big + big·small + big·big, small terms first, in fp32
(``mma.sync.m16n8k8`` with tf32 operands, three times).

This module models that arithmetic for the tests of both kernels
(tests/test_torch_flash_fwd_tf32.py, tests/test_torch_flash_bwd_tf32.py);
it is not a test file.  ``mm2`` and ``mm1`` are the variants with fewer
products, which the tests plant as faults.
"""

import numpy as np
import torch

# the fp32 gate of chip_smoke.py: max abs err <= TOL * max(1, max |ref|)
TOL = 1e-4
H = 2  # heads of every case

# (B, Sq, Sk, D, causal, k_lengths): the training head shape first, then
# the edges: a klen = 0 row, S off the 64-row tile, head dim 128, more
# keys than queries (causal and not)
CASES = {
    "causal_train_256": (2, 256, 256, 64, True, [256, 200]),
    "noncausal_train_256": (1, 256, 256, 64, False, [180]),
    "noncausal_ragged_96": (1, 96, 96, 64, False, [50]),
    "masked_row_64": (2, 64, 64, 64, False, [64, 0]),
    "causal_d128_130_zero_len": (2, 130, 130, 128, True, [0, 77]),
    "noncausal_d128_ragged_70": (2, 70, 70, 128, False, [70, 9]),
    "causal_cached_keys_20x150": (2, 20, 150, 64, True, [150, 61]),
    "noncausal_cached_keys_d128_40x100": (1, 40, 100, 128, False, [100]),
}
# the training head shape, where the planted faults (fewer products) must
# fail the gate
FAULT_CASES = ("causal_train_256", "noncausal_train_256")


def inputs(seed, B, Sq, Sk, D, n=3):
    """q, k, v (and dO when n is 4) [B, H, S, D] as float32 numpy arrays,
    standard normal from ``seed``."""
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((B, H, S, D)).astype(np.float32)
            for S in (Sq, Sk, Sk, Sq)[:n]]


def tf32(x):
    """x rounded to tf32: to nearest, ties away from zero, at 10 mantissa
    bits, on the int32 view (the magnitude sits below the sign bit)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """(big, small): x = big + small + a rest below 2^-22 |x|."""
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a, b):
    """a @ b as the kernels' three TF32 products, small terms first."""
    ab, as_ = split(a)
    bb, bs = split(b)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)) + torch.matmul(
        ab, bb)


def mm2(a, b):
    """Two TF32 products: big·big and one cross term (b's small part
    dropped), the next-fewer products after mm3."""
    ab, as_ = split(a)
    bb = tf32(b)
    return torch.matmul(as_, bb) + torch.matmul(ab, bb)


def mm1(a, b):
    """One TF32 product, operands rounded once."""
    return torch.matmul(tf32(a), tf32(b))


def gate(got, want):
    """(max abs err, bound, ok) under the fp32 gate."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    bound = TOL * max(1.0, float(np.abs(want).max()))
    return err, bound, err <= bound
