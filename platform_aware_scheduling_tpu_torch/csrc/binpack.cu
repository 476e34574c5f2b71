// GAS first-fit card bin-packing on Hopper: one warp per node.
//
// Replaces the TPU-side device program platform_aware_scheduling_tpu/ops/
// binpack.py (binpack_kernel, an XLA jit of a vmap over nodes of
// _fit_one_node, which scans containers and GPU picks and checks every card
// with _card_fits) and computes exactly what it and the port's
// ops/binpack.binpack_reference compute.  For each node, containers in
// order, then each container's GPU picks in order: the card to book is the
// fitting lane with the smallest card_order, ties to the smallest lane; a
// card may be picked again while it has room.  A lane fits when it is real
// and still in the node's GPU label and, for every resource the container
// asks for (need_active), need >= 0, the capacity is present and > 0, the
// card's used amount plus what this pod already booked on it is >= 0, and
// that amount plus need is <= capacity.  A pick is wanted while the
// container is active and the pick's step is below its GPU count; fits is
// the AND over wanted picks of "a lane fitted", and cards holds the booked
// lane of each step, -1 where nothing was booked.  Later containers still
// pick after an earlier one failed, as the scan does.
//
// No signed overflow.  The JAX code detects overflow by a sign flip after a
// wrapping add; in C++ a signed overflow is undefined.  Here the sum is
// never formed: the check is used <= capacity - need, and with
// capacity > 0 and need >= 0 the difference lies in [-INT64_MAX, INT64_MAX].
// That is the same verdict: when used + need would pass INT64_MAX it also
// passes capacity.
//
// State.  Each lane of the warp owns cards lane and lane + 32 (C <= 64) and
// keeps, for each owned card, how many times each container booked it.  A
// check rebuilds the card's amount as used + sum over containers of
// count * need; every term was checked against the capacity when it was
// booked, so no partial sum overflows.  The working state thus takes
// 2 * MAX_CONTAINERS ints a thread whatever C and R are; R is looped over,
// and the wrapper refuses C > 64 or T > 16.  Each step is two warp min
// reductions: the smallest fitting card_order, then the smallest lane with
// it.
//
// Bound: bytes.  The function must read used [N, C, R] int64, capacity
// [N, R] int64, cap_present [N, R], card_valid and card_real [N, C] and
// card_order [N, C] int32, and write fits [N] and cards [N, T, K] int32: at
// the smoke's mirror, 16384 x 8 x 4 with T = K = 2, about 5.8 MB, ~1.7 us at
// 3.35 TB/s, so one launch's overhead dominates.  The request (T x R) is
// read by every warp and stays in cache.  A warp per node leaves 24 of 32
// lanes idle at C = 8; the node count, not the lanes, fills the card.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;  // nodes a block
constexpr int SLOTS = 2;  // cards a lane: C <= 64
constexpr int MAX_CONTAINERS = 16;
constexpr int BIG_ORDER = 1 << 30;  // a lane that cannot fit (JAX big_order)

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = min(v, __shfl_xor_sync(FULL, v, offset));
  return v;
}

// Whether card `card` of the node fits one share of container `ti`, given
// the pick counts `count` of this card for containers 0..ti.
__device__ bool card_fits(const int64_t* __restrict__ used_n,
                          const int64_t* __restrict__ cap_n,
                          const bool* __restrict__ cap_present_n,
                          const int64_t* __restrict__ need,
                          const bool* __restrict__ need_active, const int* count,
                          int card, int ti, int R) {
  for (int ri = 0; ri < R; ++ri) {
    if (!need_active[ti * R + ri]) continue;
    const int64_t nd = need[ti * R + ri];
    if (nd < 0) return false;
    if (!cap_present_n[ri]) return false;
    const int64_t cap = cap_n[ri];
    if (cap <= 0) return false;
    int64_t amount = used_n[static_cast<int64_t>(card) * R + ri];
    if (amount < 0) return false;
    for (int tj = 0; tj <= ti; ++tj) {
      if (count[tj] != 0 && need_active[tj * R + ri])
        amount += static_cast<int64_t>(count[tj]) * need[tj * R + ri];
    }
    if (amount > cap - nd) return false;
  }
  return true;
}

__global__ void __launch_bounds__(WARPS * 32)
    binpack_kernel(const int64_t* __restrict__ used, const int64_t* __restrict__ capacity,
                   const bool* __restrict__ cap_present, const bool* __restrict__ card_valid,
                   const bool* __restrict__ card_real, const int32_t* __restrict__ card_order,
                   const int64_t* __restrict__ need, const bool* __restrict__ need_active,
                   const int32_t* __restrict__ num_gpus,
                   const bool* __restrict__ container_active, bool* __restrict__ fits,
                   int32_t* __restrict__ cards, int N, int C, int R, int T, int K) {
  const int lane = threadIdx.x & 31;
  const int64_t node = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (node >= N) return;  // the whole warp leaves together

  const int64_t* used_n = used + node * C * R;
  const int64_t* cap_n = capacity + node * R;
  const bool* cap_present_n = cap_present + node * R;

  int card[SLOTS];
  bool card_ok[SLOTS];
  int order[SLOTS];
  int count[SLOTS][MAX_CONTAINERS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    card[s] = lane + 32 * s;
    const bool real_lane = card[s] < C;
    const int64_t at = node * C + card[s];
    card_ok[s] = real_lane && card_valid[at] && card_real[at];
    order[s] = real_lane ? card_order[at] : BIG_ORDER;
    for (int ti = 0; ti < T; ++ti) count[s][ti] = 0;
  }

  bool ok = true;
  for (int ti = 0; ti < T; ++ti) {
    const bool active = container_active[ti];
    const int gpus = num_gpus[ti];
    for (int ki = 0; ki < K; ++ki) {
      // the JAX min over where(fits, card_order, big_order) of the C lanes
      bool fit[SLOTS];
      int mine = INT_MAX;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        fit[s] = card_ok[s] && card_fits(used_n, cap_n, cap_present_n, need, need_active,
                                         count[s], card[s], ti, R);
        if (card[s] < C) mine = min(mine, fit[s] ? order[s] : BIG_ORDER);
      }
      const int best = warp_min(mine);
      int lowest = C;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (fit[s] && order[s] == best) lowest = min(lowest, card[s]);
      const int chosen = warp_min(lowest);
      const bool fitted = chosen < C;
      const bool wanted = active && ki < gpus;
      const bool book = wanted && fitted;
      if (book) {
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          if (card[s] == chosen) ++count[s][ti];
      }
      ok = ok && (fitted || !wanted);
      if (lane == 0) cards[(node * T + ti) * K + ki] = book ? chosen : -1;
    }
  }
  if (lane == 0) fits[node] = ok;
}

}  // namespace

extern "C" {

// Largest C (card lanes a node) and T (containers) the kernel takes.
int binpack_max_cards() { return SLOTS * 32; }
int binpack_max_containers() { return MAX_CONTAINERS; }

// One launch on `stream`; returns cudaGetLastError() (0 = launched).
// used int64 [N, C, R], capacity int64 [N, R], cap_present bool [N, R],
// card_valid and card_real bool [N, C], card_order int32 [N, C], need int64
// [T, R], need_active bool [T, R], num_gpus int32 [T], container_active bool
// [T]; writes fits bool [N] and cards int32 [N, T, K].  N > 0,
// 0 < C <= binpack_max_cards(), T <= binpack_max_containers().
int binpack_launch(const void* used, const void* capacity, const void* cap_present,
                   const void* card_valid, const void* card_real, const void* card_order,
                   const void* need, const void* need_active, const void* num_gpus,
                   const void* container_active, void* fits, void* cards, int N, int C,
                   int R, int T, int K, void* stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  binpack_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(used), static_cast<const int64_t*>(capacity),
      static_cast<const bool*>(cap_present), static_cast<const bool*>(card_valid),
      static_cast<const bool*>(card_real), static_cast<const int32_t*>(card_order),
      static_cast<const int64_t*>(need), static_cast<const bool*>(need_active),
      static_cast<const int32_t*>(num_gpus), static_cast<const bool*>(container_active),
      static_cast<bool*>(fits), static_cast<int32_t*>(cards), N, C, R, T, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
