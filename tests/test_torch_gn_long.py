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

The bf16 entry's routes (`bf16_route`) and the plan of its bulk route
(`bulk_plan` in csrc/gn_bulk_plan.cuh, built here with g++ as the
launch computes it): runs of a multiple of 8 values up to BULK_MAX_RUN
on aligned tensors go through shared memory once, k runs an item;
longer ones take the two passes, ragged or misaligned ones the register
kernel. The plan is held by walking it as the kernel's blocks walk it,
and the kernel's channel of a vector (a multiply by 1/HW, corrected by
one step) by doing its float32 arithmetic here.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from slotdiffusion_tpu_torch.ops import _cuda, fused_norm
from slotdiffusion_tpu_torch.ops.fused_norm import (BULK_MAX_RUN,
                                                    LONG_CHUNK, MAX_GROUP,
                                                    bf16_route,
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


# (L, aligned, route): the flagship's runs (192 at its 4x4 level to 12,288
# at 32x32), COCO's 56x56 latents, the pixel decoder at 64x64, a
# dVAE-sized 65,536, the bulk route's limit and one vector past it, and
# the ragged test shapes' 252 and 50 values
ROUTES = [(192, True, "bulk"), (4096, True, "bulk"), (12288, True, "bulk"),
          (37632, True, "bulk"), (49152, True, "bulk"), (65536, True, "bulk"),
          (BULK_MAX_RUN, True, "bulk"), (BULK_MAX_RUN + 8, True, "two_pass"),
          (2 * 1024 * 1024, True, "two_pass"), (4096, False, "ragged"),
          (252, True, "ragged"), (50, True, "ragged"),
          (MAX_GROUP + 8, True, "bulk"), (MAX_GROUP + 8, False, "two_pass"),
          (MAX_GROUP + 4, True, "two_pass"),
          (MAX_GROUP + 1, True, "two_pass"), (MAX_GROUP - 4, True, "ragged")]


# the bulk route's plan as the launch computes it, through a C interface
PLAN_SHIM = r"""
#include "gn_bulk_plan.cuh"
using namespace sdt_gn;
extern "C" int route(long long L, int aligned) {
  return bulk_route(L, aligned != 0);
}
extern "C" void plan(int L, int runs, int sms, int CG, int* out) {
  const BulkPlan p = bulk_plan(L, runs, sms, CG);
  const int v[6] = {p.k, p.items, p.grid, p.team, p.slots, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}
extern "C" void constants(int* out) {
  const int v[10] = {kBulkThreads, kBulkPerSm, kBulkMaxVec, kBulkTeamFew,
                     kBulkTeamMany, kBulkMany, kBulkMaxRun, kBulkStage,
                     kBulkSmemSm, kBulkSlots};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
}
"""
PLAN_KEYS = ("k", "items", "grid", "team", "slots", "smem")
CONSTANT_KEYS = ("threads", "per_sm", "max_vec", "team_few", "team_many",
                 "many", "max_run", "stage", "smem_sm", "slots")


@pytest.fixture(scope="module")
def cplan(tmp_path_factory):
    """-> (plan(L, runs, sms, CG) -> dict, route(L, aligned) -> bool,
    the header's constants), from csrc/gn_bulk_plan.cuh built by g++."""
    d = tmp_path_factory.mktemp("gn_plan")
    src, so = os.path.join(d, "shim.cpp"), os.path.join(d, "libplan.so")
    with open(src, "w") as f:
        f.write(PLAN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    _cuda.CSRC, src, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.route.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.constants.argtypes = [ctypes.c_void_p]
    out = (ctypes.c_int * 10)()
    lib.constants(out)
    const = dict(zip(CONSTANT_KEYS, out))

    def plan(L, runs, sms, CG):
        lib.plan(L, runs, sms, CG, out)
        return dict(zip(PLAN_KEYS, out))
    return plan, lambda L, aligned: bool(lib.route(L, aligned)), const


@pytest.mark.parametrize("L,aligned,route", ROUTES)
def test_bf16_route_takes_each_run_to_its_path(L, aligned, route, cplan):
    """The wrapper's route, and the kernel's choice of the bulk route."""
    assert bf16_route(L, aligned) == route
    assert cplan[1](L, aligned) == (route == "bulk")
    assert cplan[2]["max_run"] == BULK_MAX_RUN


# (B, C, H*W, G): every flagship level at 12 and 192 frames, COCO's
# 56x56 levels, and the long runs of the bulk route
PLAN_SHAPES = [(B, C, hw, 32) for B in (12, 192)
               for C, hw in ((128, 1024), (256, 1024), (384, 1024),
                             (256, 256), (384, 256), (384, 64), (512, 64),
                             (512, 16), (384, 16))] + [
    (8, 192, 3136, 32), (8, 384, 3136, 32), (8, 384, 784, 32),
    (8, 384, 196, 32), (2, 384, 4096, 32), (1, 128, 16384, 32),
    (1, 32, 3072, 1), (3, 8, 1, 1)]


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_bulk_plan_covers_each_run_once_in_order(shape, sms, cplan):
    B, C, hw, G = shape
    L, runs = C // G * hw, B * G
    assert bf16_route(L, True) == "bulk"
    plan, _, K = cplan
    p = plan(L, runs, sms, C // G)
    k, items, grid, team = p["k"], p["items"], p["grid"], p["team"]
    # an item packs runs up to the stage's values (one run when longer)
    assert 1 <= k and k * L <= max(L, K["stage"])
    assert items == -(-runs // k)
    # one stage and the affine slots a block, within an SM's shared memory
    assert p["smem"] == 2 * k * L + p["slots"] <= K["smem_sm"]
    assert 0 <= p["slots"] <= K["slots"]
    # one wave of at most per_sm blocks an SM, as many as their shared
    # memory holds
    per_sm = -(-grid // sms)
    assert 1 <= grid <= items and per_sm <= K["per_sm"]
    assert per_sm * (p["smem"] + 1024) <= K["smem_sm"] or per_sm == 1
    # walk it as the kernel does: block b takes items b, b + grid, ...,
    # item i runs [i * k, min(i * k + k, runs)), all in increasing order
    seen = np.zeros(runs, np.int32)
    for b in range(grid):
        last = -1
        for i in range(b, items, grid):
            lo, hi = i * k, min(i * k + k, runs)
            assert last < lo < hi
            seen[lo:hi] += 1
            last = hi - 1
    assert (seen == 1).all()
    # each team takes at most one run an item; k is the fewest runs an
    # item that keep the items within one block an SM (one fewer would
    # not), unless the teams or the stage cap it
    cap = min(max(1, K["stage"] // L), K["threads"] // team)
    assert k <= cap
    assert k == cap or items <= sms
    assert k == 1 or -(-runs // (k - 1)) > sms


@pytest.mark.parametrize("runs", [1, 384, 6144])
@pytest.mark.parametrize("L", [8, 64, 192, 256, 512, 768, 1024, 2048, 4096,
                               8192, 12288, 37632, BULK_MAX_RUN])
def test_a_team_reads_each_vector_once_and_its_order_is_the_calls(L, runs,
                                                                  cplan):
    """The team that reduces a run: a power of two of threads, from a
    warp where the call's runs are few and from the least team of many
    runs where there are that many or more an SM, within a warp or whole
    warps (the kernel's shuffles and named barriers), the fewest that
    read at most max_vec vectors each a pass unless it is the block;
    threads i, i + t, ... read each vector once. It depends on the call's
    shape alone, not on what sets k and the grid (the affine's slots), so
    a call's bits do not depend on them."""
    sms = 132
    plan, _, K = cplan
    least = K["team_many"] if runs >= K["many"] * sms else K["team_few"]
    t = plan(L, runs, sms, 1)["team"]
    assert t >= least and t & (t - 1) == 0 and t <= K["threads"]
    assert t <= 32 or t % 32 == 0
    V = L // 8
    assert t * K["max_vec"] >= V or t == K["threads"]
    assert t == least or (t // 2) * K["max_vec"] < V
    seen = np.zeros(V, np.int32)
    for lane in range(t):
        seen[lane::t] += 1
    assert (seen == 1).all()
    # channels a group change the slots, the shared memory and the grid,
    # not the team
    plans = [plan(L, runs, sms, cg) for cg in (1, 4, 28, 4096)]
    assert len({q["smem"] for q in plans}) > 1
    assert {q["team"] for q in plans} == {t}


@pytest.mark.parametrize("HW", [1, 3, 7, 16, 49, 196, 784, 3136, 4096,
                                12345])
def test_bulk_channel_of_a_vector_is_exact(HW):
    """The kernel's channel of the vector at value idx = 8 i of a run:
    idx >> log2(HW) for a power of two, else trunc(f32(idx) * f32(1/HW))
    with one step of correction; -> idx // HW at every vector of the
    longest bulk run."""
    idx = np.arange(0, BULK_MAX_RUN, 8, dtype=np.int64)
    inv = np.float32(1.0) / np.float32(HW)
    c = (idx.astype(np.float32) * inv).astype(np.int64)  # rounds to zero
    rem = idx - c * HW
    c = np.where(rem < 0, c - 1, np.where(rem >= HW, c + 1, c))
    np.testing.assert_array_equal(c, idx // HW)


def test_route_counts_reset_and_replay_with_the_launch_counts():
    """The bf16 entry's launches by route are read, reset and carried over
    a graph's replay with the other counts, so a path's route counts are
    its own."""
    from slotdiffusion_tpu_torch import ops
    ops.reset_launch_counts()
    before = ops.launches_by_entry()
    fused_norm.launches["sdt_group_norm_bf16"] += 3
    fused_norm.route_launches["sdt_group_norm_bf16.bulk"] += 3
    captured = ops.launches_since(before)
    assert captured["sdt_group_norm_bf16.bulk"] == 3
    ops.add_launches(captured)  # a replay
    assert fused_norm.route_launches["sdt_group_norm_bf16.bulk"] == 6
    assert ops.launch_counts()["gn_silu_bf16"] == 6
    ops.reset_launch_counts()
    assert not any(fused_norm.route_launches.values())
    assert not any(ops.launch_counts().values())
