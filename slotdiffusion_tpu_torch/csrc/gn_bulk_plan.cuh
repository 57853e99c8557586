// The plan of the bf16 GroupNorm entry's bulk route (`gn_bulk_bf16` in
// group_norm.cu): which runs take it, and how a call of them is laid out
// on the card. The launch computes it from the call's shape and the
// card's SM count; nothing else plans it. Plain C++ with no CUDA header,
// so that it also builds with a host compiler alone
// (tests/test_torch_gn_long.py builds it with g++ and walks the plan as
// the kernel's blocks walk it).
#pragma once

namespace sdt_gn {

constexpr int kBulkThreads = 128;   // a block
constexpr int kBulkWarps = kBulkThreads / 32;
constexpr int kBulkPerSm = 8;       // most blocks an SM
constexpr int kBulkMaxVec = 8;      // vectors of 8 values a thread a pass
constexpr int kBulkTeamFew = 32;    // least threads of a team: few runs
constexpr int kBulkTeamMany = 8;    // and many runs an SM, which are
constexpr int kBulkMany = 8;        // at least this many
constexpr int kBulkMaxRun = 98304;  // values of a run: 192 KB of bf16
constexpr int kBulkStage = 8192;    // values of the runs one copy packs
constexpr int kBulkSmemSm = 225280;  // shared memory of an SM's blocks
constexpr int kBulkSlots = 8192;    // most bytes of a block's affine slots

// Runs of L values on x and y that are (`aligned`) or are not 16-byte
// aligned take the bulk route: the bulk copy moves 16-byte sizes between
// 16-byte addresses, and the stage holds a run (`bf16_route` in
// ops/fused_norm.py names the same routes)
inline bool bulk_route(long long L, bool aligned) {
  return aligned && L % 8 == 0 && L <= kBulkMaxRun;
}

struct BulkPlan {
  int k;      // runs an item: one bulk copy of k consecutive runs
  int items;  // items of the call
  int grid;   // blocks: one resident wave, block b takes b, b + grid, ...
  int team;   // threads that reduce one run together
  int slots;  // bytes of a block's affine slots; 0: read where used
  int smem;   // dynamic shared memory of a block: its stage and slots
};

// The plan for `runs` runs of L values (CG channels a group) on `sms` SMs:
// - the team: the fewest threads, from a least team up by powers of two,
//   that read at most kBulkMaxVec vectors of 8 values each a pass, at
//   most the block. The least team is a warp where the runs are few, as
//   a small call's time is one run's chain, and kBulkTeamMany threads
//   where there are kBulkMany or more runs an SM, so that an SM reduces
//   more runs at once. It depends on the call's shape, not on k or the
//   grid, and so does the order of a run's sums;
// - k: the fewest runs an item that spread the call over one block an
//   SM, at most one for each team of a block and at most kBulkStage
//   values (one run when it is longer);
// - the affine slots: two runs' C/G scales and shifts for each team;
// - as many blocks an SM (at most kBulkPerSm) as its shared memory holds,
//   the grid one wave of them.
inline BulkPlan bulk_plan(int L, int runs, int sms, int CG) {
  BulkPlan p;
  p.team = runs >= kBulkMany * sms ? kBulkTeamMany : kBulkTeamFew;
  while (p.team < kBulkThreads && p.team * kBulkMaxVec < L / 8) p.team *= 2;
  const int teams = kBulkThreads / p.team;
  p.k = kBulkStage / L;
  if (p.k > teams) p.k = teams;
  if (p.k > (runs + sms - 1) / sms) p.k = (runs + sms - 1) / sms;
  if (p.k < 1) p.k = 1;
  p.items = (runs + p.k - 1) / p.k;
  const long long slots = (long long)teams * 4 * CG * 4;
  p.slots = slots <= kBulkSlots ? (int)slots : 0;
  p.smem = 2 * p.k * L + p.slots;
  int per_sm = kBulkSmemSm / (p.smem + 1024);
  if (per_sm > kBulkPerSm) per_sm = kBulkPerSm;
  if (per_sm < 1) per_sm = 1;
  p.grid = p.items < per_sm * sms ? p.items : per_sm * sms;
  return p;
}

}  // namespace sdt_gn
