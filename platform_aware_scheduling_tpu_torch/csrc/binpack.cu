// GAS first-fit card bin-packing on Hopper: a lane per card.
//
// Replaces platform_aware_scheduling_tpu/ops/binpack.py binpack_kernel (an
// XLA jit of a vmap over nodes of _fit_one_node, which scans containers
// and GPU picks and checks every card with _card_fits) and computes exactly
// what it and the port's ops/binpack.binpack_reference compute.  For each
// node, containers in order, then each container's GPU picks in order: the
// card to book is the fitting lane with the smallest card_order, ties to
// the smallest lane; a card may be picked again while it has room.  A lane
// fits when it is real and still in the node's GPU label and, for every
// resource the container asks for (need_active), need >= 0, the capacity
// is present and > 0, the card's running amount is >= 0, and that amount
// plus need is <= capacity.  A pick is wanted while the container is
// active and the pick's step is below its GPU count; fits is the AND over
// wanted picks of "a lane fitted", and cards holds the booked lane of each
// step, -1 where nothing was booked.  Later containers still pick after an
// earlier one failed, as the scan does.
//
// Layout.  A node's C cards spread over a group of G lanes, G the next
// power of two >= C (at most 32), so 32 / G nodes share a warp: at C = 8
// four nodes a warp and no idle lane.  For C from 33 to 64 a warp takes
// one node and each lane two cards (lane and lane + 32).  Lanes past C are
// padding: they are not JAX lanes and take part in no min.  One template
// instance per (G, cards a lane, resources held in registers: 4 for
// R <= 4, else 8); the launcher picks it.
//
// State: the reference's own carry.  The JAX scan carries used2, each
// card's amount with every share booked so far.  Here each lane keeps the
// same carry measured from the other end, its card's room for each
// resource: room = capacity - amount, in registers for R <= 8 (past 8 in
// dynamic shared memory, or in a scratch the wrapper allocates when a
// block's share would not fit in 40 KB).  A share fits where
// need <= room, and booking it takes need off the room, so a pick needs
// neither a sum nor a subtraction of the capacity.  Every index into the
// register arrays is a compile-time constant: the state takes no stack.
//
// No signed overflow.  The JAX code detects overflow by a sign flip after
// a wrapping add; in C++ a signed overflow is undefined.  Here no sum is
// formed that could overflow.  room starts as capacity - used only where
// the capacity is present and > 0 and used >= 0 (so the difference lies in
// (-INT64_MAX, INT64_MAX]), else -1, which no need >= 0 fits.  need <= room
// is then the JAX verdict: room >= 0 holds used <= capacity, and
// used + need <= capacity without overflow is need <= capacity - used.
// An amount grows only by a need that was just checked as
// need <= capacity - amount, so the room shrinks to no less than 0.  A
// resource not asked for checks against INT64_MIN and books 0.
//
// Selection.  The JAX step takes best = the min over the C lanes of
// where(fits, order, 2^30), then the lowest fitting lane whose order is
// best.  Two steps give both: a min of (fits ? order : 2^30), as ordered
// unsigned keys, over the group (log2 G __shfl_xor_sync steps), then a
// warp ballot of the fitting lanes whose key is best, whose lowest set bit
// in the group's share is the pick.  So a fitting lane whose order is
// exactly 2^30 beats a lower lane that does not fit, and a fitting lane
// whose order passes 2^30 is lost beside any real lane that does not fit,
// as in JAX.  Where no card of the warp's nodes fits, one vote skips both
// steps.
//
// Bound: bytes.  The function must read used [N, C, R] int64, capacity
// [N, R] int64, cap_present [N, R], card_valid and card_real [N, C],
// card_order [N, C] int32 and the request, and write fits [N] and cards
// [N, T, K] int32: at the GAS Filter's mirror, 16384 x 8 x 4 with
// T = K = 2, 5,849,170 bytes, 1.746 us at 3.35 TB/s.  The design goes for
// that bound by reading each byte once and all of it at once: the block
// first stages the request (need, need_active, num_gpus,
// container_active) in shared memory, then every lane issues all its
// loads (its card's R amounts as 16-byte vectors where R is 4 or 8, its
// node's capacity row and presence flags, its card's flags and order),
// none waiting on another's value; a group's loads cover its node's contiguous
// [C, R] row (256 B a node, 1 KB a warp at the main shape).  The barrier
// waits for the request alone, and the T x K picks run from registers and
// shared memory with no load from device memory; a group's first lane
// writes each pick.  What the card spends beyond the bound (PERF.md): a
// kernel's own launch and drain, and the picks, each a chain of
// dependent steps that every lane of a group runs.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;  // a block's threads, unless rooms past 8 resources shrink it
constexpr int MAX_CARDS = 64;
constexpr int MAX_CONTAINERS = 16;
constexpr int REG_RESOURCES = 8;  // resources whose rooms a lane holds in registers
constexpr int EXTRA_SMEM = 40 * 1024;  // dynamic shared memory for the rooms past those
constexpr unsigned SIGN = 0x80000000u;  // int32 ^ SIGN orders as an unsigned
// the key of a lane that does not fit: JAX big_order, 2^30
constexpr unsigned BIG_KEY = (1u << 30) ^ SIGN;

struct Args {
  const long long* used;
  const long long* capacity;
  const bool* cap_present;
  const bool* card_valid;
  const bool* card_real;
  const int* card_order;
  const long long* need;
  const bool* need_active;
  const int* num_gpus;
  const bool* container_active;
  bool* fits;
  int* cards;
  long long* scratch;  // the rooms past REG_RESOURCES when shared memory cannot hold them
  int N, C, R, T, K;
  bool vec;  // R is the instance's RREG, used and capacity 16-byte aligned
};

// The request, staged once a block.
template <int RREG>
struct Request {
  long long check[MAX_CONTAINERS][RREG];  // need where asked for, INT64_MIN where not
  long long booked[MAX_CONTAINERS][RREG];  // need where asked for, 0 where not
  bool never[MAX_CONTAINERS];  // a resource asked for with need < 0: no card fits
  int gpus[MAX_CONTAINERS];  // num_gpus, 0 for an inactive container
};

// A card's room for one resource: capacity - used where the capacity is
// present and > 0 and used >= 0, else -1 (no share fits).  No overflow:
// capacity > 0 and used >= 0.
__device__ __forceinline__ long long room_of(long long used, long long cap, bool present) {
  return present && cap > 0 && used >= 0 ? cap - used : -1;
}

template <int G, int SLOTS, int RREG>
__global__ void __launch_bounds__(THREADS) binpack_kernel(const Args a) {
  __shared__ Request<RREG> req;
  extern __shared__ long long extra_smem[];

  const int tid = threadIdx.x;
  const int glane = tid & (G - 1);
  const int group_base = tid & 31 & ~(G - 1);  // the group's first lane in the warp
  const long long node = SLOTS == 1
                             ? static_cast<long long>(blockIdx.x) * (blockDim.x / G) + tid / G
                             : static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + tid / 32;
  const int C = a.C, R = a.R, T = a.T, K = a.K;
  const bool live = node < a.N;  // a group past N runs the shuffles and writes nothing
  // resources past RREG exist only in the instance that holds REG_RESOURCES
  const int nextra = RREG == REG_RESOURCES && R > RREG ? R - RREG : 0;
  // this lane's room for resources past RREG: element (e * SLOTS + s) * blockDim.x
  long long* extra =
      (a.scratch ? a.scratch + static_cast<long long>(blockIdx.x) * nextra * SLOTS * blockDim.x
                 : extra_smem) +
      tid;

  // Every load from device memory first, none waiting on another's value,
  // so one latency covers them all.  The request comes first, so the
  // barrier below does not wait behind the node rows.
  for (int i = tid; i < T * RREG; i += blockDim.x) {
    const int ti = i / RREG, ri = i % RREG;
    bool on = false;
    long long need = 0;
    if (ri < R) {
      on = a.need_active[ti * R + ri];
      need = a.need[ti * R + ri];
    }
    req.check[ti][ri] = on ? need : LLONG_MIN;
    req.booked[ti][ri] = on ? need : 0;
  }
  for (int ti = tid; ti < T; ti += blockDim.x) {
    const bool active = a.container_active[ti];
    const int gpus = a.num_gpus[ti];
    bool never = false;
#pragma unroll
    for (int ri = 0; ri < RREG; ++ri) {
      bool on = false;
      long long need = 0;
      if (ri < R) {
        on = a.need_active[ti * R + ri];
        need = a.need[ti * R + ri];
      }
      never |= on & (need < 0);
    }
#pragma unroll 1
    for (int ri = RREG; ri < RREG + nextra; ++ri)
      never |= a.need_active[ti * R + ri] && a.need[ti * R + ri] < 0;
    req.never[ti] = never;
    req.gpus[ti] = active ? gpus : 0;
  }

  int card[SLOTS], order[SLOTS];
  bool real[SLOTS], valid[SLOTS], real_card[SLOTS];
  long long used[SLOTS][RREG];
  long long cap[RREG];
  bool present[RREG];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    card[s] = glane + 32 * s;
    real[s] = live && card[s] < C;
    const long long at = node * C + card[s];
    valid[s] = real_card[s] = false;
    order[s] = 0;
    if (real[s]) {
      valid[s] = a.card_valid[at];
      real_card[s] = a.card_real[at];
      order[s] = a.card_order[at];
    }
    const long long* row = a.used + at * R;
    if (real[s] && a.vec) {
#pragma unroll
      for (int ri = 0; ri < RREG; ri += 2) {
        const longlong2 v = *reinterpret_cast<const longlong2*>(row + ri);
        used[s][ri] = v.x;
        used[s][ri + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int ri = 0; ri < RREG; ++ri) used[s][ri] = real[s] && ri < R ? row[ri] : 0;
    }
  }
  const long long* cap_row = a.capacity + node * R;
  const bool* present_row = a.cap_present + node * R;
  if (live && a.vec) {
#pragma unroll
    for (int ri = 0; ri < RREG; ri += 2) {
      const longlong2 v = *reinterpret_cast<const longlong2*>(cap_row + ri);
      cap[ri] = v.x;
      cap[ri + 1] = v.y;
    }
#pragma unroll
    for (int ri = 0; ri < RREG; ++ri) present[ri] = present_row[ri];
  } else {
#pragma unroll
    for (int ri = 0; ri < RREG; ++ri) {
      cap[ri] = 0;
      present[ri] = false;
      if (live && ri < R) {
        cap[ri] = cap_row[ri];
        present[ri] = present_row[ri];
      }
    }
  }
  // The barrier waits for the request alone: nothing loaded above is used
  // before it, so each warp goes on when its own rows arrive.
  __syncthreads();

#pragma unroll 1
  for (int e = 0; e < nextra; ++e) {
    const int ri = RREG + e;
    for (int s = 0; s < SLOTS; ++s)
      extra[(e * SLOTS + s) * blockDim.x] =
          real[s] ? room_of(a.used[(node * C + card[s]) * R + ri], cap_row[ri], present_row[ri])
                  : -1;
  }

  // The carry: each card's room for each resource, capacity - used2 of
  // the JAX scan.  A share fits where need <= room; booking it takes need
  // off the room, which stays >= 0.
  long long room[SLOTS][RREG];
  bool ok_card[SLOTS];
  unsigned order_key[SLOTS];  // card_order as an ordered unsigned
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    ok_card[s] = valid[s] & real_card[s];
    order_key[s] = static_cast<unsigned>(order[s]) ^ SIGN;
#pragma unroll
    for (int ri = 0; ri < RREG; ++ri) room[s][ri] = room_of(used[s][ri], cap[ri], present[ri]);
  }

  bool ok = true;
  int* out = a.cards + node * T * K;  // this node's picks, written by its first lane
  const bool writer = live && glane == 0;
  for (int ti = 0; ti < T; ++ti) {
    long long check[RREG], booked[RREG];
#pragma unroll
    for (int ri = 0; ri < RREG; ++ri) {
      check[ri] = req.check[ti][ri];
      booked[ri] = req.booked[ti][ri];
    }
    const bool never = req.never[ti];
    const int gpus = req.gpus[ti];
    for (int ki = 0; ki < K; ++ki) {
      int picked = -1;
      if (ki < gpus) {  // uniform over the block
        bool fit[SLOTS], any = false;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          fit[s] = ok_card[s] && !never;
#pragma unroll
          for (int ri = 0; ri < RREG; ++ri) fit[s] &= check[ri] <= room[s][ri];
#pragma unroll 1
          for (int e = 0; e < nextra && fit[s]; ++e) {
            const int ri = RREG + e;
            fit[s] = !a.need_active[ti * R + ri] ||
                     a.need[ti * R + ri] <= extra[(e * SLOTS + s) * blockDim.x];
          }
          any |= fit[s];
        }
        // where no card of the warp's nodes fits, no group picks
        if (__any_sync(FULL, any)) {
          // best: the min over real lanes of where(fits, order, 2^30); a
          // padding lane's ~0u never lowers it
          unsigned best = ~0u;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
            if (real[s]) best = min(best, fit[s] ? order_key[s] : BIG_KEY);
#pragma unroll
          for (int offset = G / 2; offset > 0; offset >>= 1)
            best = min(best, __shfl_xor_sync(FULL, best, offset));
          // the pick: the lowest fitting lane whose order is best, the
          // first set bit of the group's share of a warp ballot
#pragma unroll
          for (int s = SLOTS - 1; s >= 0; --s) {
            const unsigned on_best =
                __ballot_sync(FULL, fit[s] && order_key[s] == best) >> group_base;
            const unsigned group_bits = G == 32 ? on_best : on_best & ((1u << G) - 1);
            if (group_bits) picked = 32 * s + __ffs(group_bits) - 1;
          }
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const bool mine = card[s] == picked;
#pragma unroll
            for (int ri = 0; ri < RREG; ++ri) room[s][ri] -= mine ? booked[ri] : 0;
            if (nextra && mine) {
#pragma unroll 1
              for (int e = 0; e < nextra; ++e)
                if (a.need_active[ti * R + RREG + e])
                  extra[(e * SLOTS + s) * blockDim.x] -= a.need[ti * R + RREG + e];
            }
          }
        }
        ok = ok && picked >= 0;
      }
      if (writer) out[ki] = picked;
    }
    out += K;
  }
  if (writer) a.fits[node] = ok;
}

struct Plan {
  int threads;
  size_t smem;
  long long scratch;  // elements of scratch the wrapper must pass, 0 for none
  int blocks;
};

int group_width(int C) {
  int g = 1;
  while (g < C && g < 32) g <<= 1;
  return g;
}

int register_resources(int R) { return R <= 4 ? 4 : REG_RESOURCES; }

Plan plan_for(int N, int C, int R) {
  const int slots = C > 32 ? 2 : 1;
  const int rreg = register_resources(R);
  Plan plan{THREADS, 0, 0, 0};
  bool use_scratch = false;
  if (R > rreg) {
    const size_t per_thread = static_cast<size_t>(R - rreg) * slots * sizeof(long long);
    const size_t fit = EXTRA_SMEM / per_thread / 32 * 32;
    if (fit >= 32) {
      plan.threads = fit < THREADS ? static_cast<int>(fit) : THREADS;
      plan.smem = plan.threads * per_thread;
    } else {
      use_scratch = true;
    }
  }
  const int nodes_per_block = slots == 2 ? plan.threads / 32 : plan.threads / group_width(C);
  plan.blocks =
      static_cast<int>((static_cast<long long>(N) + nodes_per_block - 1) / nodes_per_block);
  if (use_scratch)
    plan.scratch = static_cast<long long>(plan.blocks) * plan.threads * (R - rreg) * slots;
  return plan;
}

template <int G, int SLOTS, int RREG>
void launch(const Args& a, const Plan& plan, cudaStream_t stream) {
  binpack_kernel<G, SLOTS, RREG><<<plan.blocks, plan.threads, plan.smem, stream>>>(a);
}

template <int RREG>
void launch_for_width(const Args& a, const Plan& plan, cudaStream_t stream) {
  if (a.C > 32) return launch<32, 2, RREG>(a, plan, stream);
  switch (group_width(a.C)) {
    case 1: return launch<1, 1, RREG>(a, plan, stream);
    case 2: return launch<2, 1, RREG>(a, plan, stream);
    case 4: return launch<4, 1, RREG>(a, plan, stream);
    case 8: return launch<8, 1, RREG>(a, plan, stream);
    case 16: return launch<16, 1, RREG>(a, plan, stream);
    default: return launch<32, 1, RREG>(a, plan, stream);
  }
}

}  // namespace

extern "C" {

// Largest C (card lanes a node) and T (containers) the kernel takes.
int binpack_max_cards() { return MAX_CARDS; }
int binpack_max_containers() { return MAX_CONTAINERS; }

// Largest R whose rooms a lane holds in registers: a launch with a
// larger R may need a scratch (binpack_scratch_elems).
int binpack_register_resources() { return REG_RESOURCES; }

// int64 elements of the scratch a launch at this shape needs, 0 for none.
long long binpack_scratch_elems(int N, int C, int R) { return plan_for(N, C, R).scratch; }

// One launch on `stream`; returns cudaGetLastError() (0 = launched).
// used int64 [N, C, R], capacity int64 [N, R], cap_present bool [N, R],
// card_valid and card_real bool [N, C], card_order int32 [N, C], need int64
// [T, R], need_active bool [T, R], num_gpus int32 [T], container_active bool
// [T]; writes fits bool [N] and cards int32 [N, T, K].  scratch holds
// binpack_scratch_elems(N, C, R) int64 (null when that is 0).  N > 0,
// 0 < C <= binpack_max_cards(), T <= binpack_max_containers().
int binpack_launch(const void* used, const void* capacity, const void* cap_present,
                   const void* card_valid, const void* card_real, const void* card_order,
                   const void* need, const void* need_active, const void* num_gpus,
                   const void* container_active, void* fits, void* cards, void* scratch,
                   int N, int C, int R, int T, int K, void* stream) {
  const Plan plan = plan_for(N, C, R);
  if (plan.scratch > 0 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rreg = register_resources(R);
  const bool aligned = reinterpret_cast<uintptr_t>(used) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(capacity) % 16 == 0;
  const Args a{static_cast<const long long*>(used),
               static_cast<const long long*>(capacity),
               static_cast<const bool*>(cap_present),
               static_cast<const bool*>(card_valid),
               static_cast<const bool*>(card_real),
               static_cast<const int*>(card_order),
               static_cast<const long long*>(need),
               static_cast<const bool*>(need_active),
               static_cast<const int*>(num_gpus),
               static_cast<const bool*>(container_active),
               static_cast<bool*>(fits),
               static_cast<int*>(cards),
               plan.scratch > 0 ? static_cast<long long*>(scratch) : nullptr,
               N, C, R, T, K,
               R == rreg && aligned};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rreg == 4)
    launch_for_width<4>(a, plan, s);
  else
    launch_for_width<REG_RESOURCES>(a, plan, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
