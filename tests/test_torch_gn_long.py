"""The GroupNorm kernel's long-run path, on the CPU (no card here).

Runs of more than MAX_GROUP values take the kernel's two passes
(csrc/group_norm.cu): `long_plan` splits a run into chunks, a first
kernel writes each chunk's mean and centered sum of squares, a second
combines them in chunk order by Chan's formula. These tests hold the
host's plan (every value of a run in exactly one chunk, in order, each
chunk within LONG_CHUNK and a multiple of 4 but the last) and the
combine itself, emulated in float32 numpy over that plan, against the
plain version `group_norm_reference` at the shapes that reach the path:
f32 tolerance 1e-4 of the largest output, as the card check in
chip_smoke.py uses.
"""

import numpy as np
import pytest
import torch

from slotdiffusion_tpu_torch.ops import fused_norm
from slotdiffusion_tpu_torch.ops.fused_norm import (LONG_CHUNK, MAX_GROUP,
                                                    group_norm_reference,
                                                    long_plan)

# (B, C, side, groups): the UNet's 384-channel norm at 56x56 latents
# (37,632 values a group), the pixel decoder at 64x64 (49,152), 128
# channels at 128x128 (65,536), and a ragged run just over the limit
LONG_SHAPES = [(2, 384, 56, 32), (1, 384, 64, 32), (1, 128, 128, 32),
               (1, 32769, 1, 1)]


@pytest.mark.parametrize("L", [MAX_GROUP + 1, MAX_GROUP + 4, 37632, 49152,
                               65536, 100003, 8 * MAX_GROUP + 5])
def test_long_plan_covers_each_run_once_in_order(L):
    chunk, count = long_plan(L)
    assert chunk % 4 == 0 and 0 < chunk <= LONG_CHUNK
    assert count == -(-L // LONG_CHUNK)  # as few chunks as the limit allows
    edges = [(i * chunk, min((i + 1) * chunk, L)) for i in range(count)]
    covered = np.zeros(L, np.int32)
    for lo, hi in edges:
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert [lo for lo, _ in edges] == sorted(lo for lo, _ in edges)
    assert edges[-1][1] - edges[-1][0] <= chunk


def _two_pass(x, weight, bias, G, eps, silu):
    """The kernel's arithmetic in float32 numpy: chunk means and M2 over
    the plan, Chan's combine in chunk order, the folded affine."""
    B, C = x.shape[:2]
    runs = x.reshape(B * G, -1).astype(np.float32)
    L = runs.shape[1]
    chunk, count = long_plan(L)
    f = np.float32
    mean_r, rstd_r = np.empty(B * G, f), np.empty(B * G, f)
    for r in range(B * G):
        na, mean, m2 = f(0), f(0), f(0)
        for i in range(count):
            v = runs[r, i * chunk:(i + 1) * chunk]
            nb = f(v.size)
            mb = f(v.sum(dtype=f) / nb)
            m2b = ((v - mb) ** 2).sum(dtype=f)
            nt = na + nb
            d = mb - mean
            mean = f(mean + d * (nb / nt))
            m2 = f(m2 + m2b + d * d * (na * nb / nt))
            na = nt
        mean_r[r], rstd_r[r] = mean, f(1) / np.sqrt(m2 / f(L) + f(eps))
    ch = np.arange(C) // (C // G)
    a = rstd_r.reshape(B, G)[:, ch] * weight[None]
    b = bias[None] - mean_r.reshape(B, G)[:, ch] * a
    y = x * a[..., None, None] + b[..., None, None]
    return y / (1 + np.exp(-y)) if silu else y


@pytest.mark.parametrize("shape", LONG_SHAPES)
def test_two_pass_combine_matches_the_plain_version(shape):
    B, C, side, G = shape
    r = np.random.RandomState(sum(shape))
    # an offset mean: a one-pass E[x^2] - E[x]^2 would lose digits here
    x = (3.0 + r.randn(B, C, side, side)).astype(np.float32)
    w = (1 + 0.1 * r.randn(C)).astype(np.float32)
    b = (0.1 * r.randn(C)).astype(np.float32)
    assert C // G * side * side > MAX_GROUP
    want = group_norm_reference(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), G, 1e-5, "silu").numpy()
    got = _two_pass(x, w, b, G, 1e-5, True)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
