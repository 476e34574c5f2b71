// The fused TAS+GAS solve's scan over the pods on Hopper.
//
// Replaces the scan of platform_aware_scheduling_tpu/models/fused.py
// fused_schedule (:171, the lax.scan over pods after _all_fits) and
// computes exactly what it and the port's models/fused.fused_scan_reference
// compute.  For each pod in order: among the nodes where
// eligible[p] & capacity > 0 & fits[class[p]], take the largest int64 score,
// ties to the lowest node index (none: -1, and nothing is booked).  Booking
// re-packs the chosen node's cards first-fit with the pod's class, as GAS
// Bind does (containers in order, then GPU picks in order; the card is the
// fitting lane with the smallest card_order, ties to the smallest lane; a
// card may be picked again while it has room), takes one slot of its
// capacity and refits that node alone for every class, since no other
// node's fits can change.  A card fits a share when it is real and still in
// the node's GPU label and, for every resource the container asks for,
// need >= 0, the capacity is present and > 0, the booked amount is >= 0 and
// amount <= capacity - need: no sum is formed, so nothing can overflow.  A
// fitting card whose order passes 2^30 is lost beside a card that does not
// fit (the reference keys a card that does not fit at 2^30).
//
// Design: a grid of one block an SM, launched cooperatively, owns the
// nodes in contiguous chunks; the pods are walked in order, one grid-wide
// barrier a pod.  For pod p every block reduces its chunk (score
// descending, index ascending) over the ok lanes in registers, a warp
// shuffle and shared memory, and writes its best to a partials buffer (two
// of them, by the pod's parity, so one barrier a pod is enough).  After the
// barrier every block reduces the partials itself; the block that owns the
// winner books it with one warp (a lane per card, the node's [C, R] amounts
// staged in shared memory, each pick a warp min of the keys and of the
// fitting lanes at the best key) and refits its [T] column, while the
// other blocks go on to pod p + 1.  Capacity, fits and usage live in the
// output tensors; only a chunk's owner reads or writes them, so a block's
// own barrier orders them and the grid barrier orders only the partials,
// which go through L2 (__stcg / __ldcg).
//
// Bound: bytes.  The function must read score int64 [P, N], eligible
// [P, N], capacity int32 [N], req_class int32 [P], fits0 [T, N], used int64
// [N, C, R], capacity int64 [N, R], cap_present [N, R], card_valid and
// card_real [N, C], card_order int32 [N, C] and the classes, and write
// node_for_pod int32 [P], capacity_left int32 [N], used and fits: at
// 1000 x 10,000 with 8 cards, 3 resources and 3 classes, about 94.7 MB,
// 0.028 ms at 3.35 TB/s.  What holds the kernel back is the chain of 1,000
// dependent steps: each waits for a grid barrier, a reduction of the
// partials and, in one block, a booking of T x K picks done by one warp, so
// the card's time is that chain's latency, not its bytes.  Spreading each
// step's candidates over every SM ahead of the chain (as the greedy kernel
// does) is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CARDS = 64;
constexpr int MAX_CONTAINERS = 16;
constexpr int MAX_ROW = 2048;  // C x R amounts of the booked node a block stages
constexpr int BIG_ORDER = 1 << 30;  // the key of a card that does not fit
constexpr int NONE = INT_MAX;  // no ok lane

struct Args {
  const long long* score;
  const bool* eligible;
  const int* capacity;
  const int* req_class;
  const bool* fits0;
  const long long* used;
  const long long* gas_capacity;
  const bool* cap_present;
  const bool* card_valid;
  const bool* card_real;
  const int* card_order;
  const long long* need;
  const bool* need_active;
  const int* num_gpus;
  const bool* container_active;
  int* node_for_pod;
  int* capacity_left;
  long long* used_out;
  bool* fits;
  long long* partial_score;  // [2, gridDim.x]
  int* partial_node;  // [2, gridDim.x]
  long long P;
  int N, C, R, T, TC, K;
  int chunk;  // nodes a block owns
};

struct Best {
  long long score;
  int node;  // NONE where no lane was ok
};

// a before b: an ok lane before none, then the larger score, then the
// smaller node
__device__ __forceinline__ bool before(const Best& a, const Best& b) {
  if (a.node == NONE) return false;
  if (b.node == NONE) return true;
  return a.score > b.score || (a.score == b.score && a.node < b.node);
}

__device__ __forceinline__ Best warp_best(Best b) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    Best other{__shfl_xor_sync(FULL, b.score, offset), __shfl_xor_sync(FULL, b.node, offset)};
    if (before(other, b)) b = other;
  }
  return b;
}

// Whether card c of the staged row takes one share of container ti of
// class cls (the port's ops/binpack._card_fits for one card).
__device__ __forceinline__ bool card_fits(const Args& a, const long long* row, const long long* cap,
                                          const bool* present, int c, int cls, int ti) {
  const long long base = (static_cast<long long>(cls) * a.TC + ti) * a.R;
  for (int r = 0; r < a.R; ++r) {
    if (!a.need_active[base + r]) continue;
    const long long need = a.need[base + r];
    const long long amount = row[c * a.R + r];
    if (!(need >= 0 && present[r] && cap[r] > 0 && amount >= 0 && amount <= cap[r] - need)) return false;
  }
  return true;
}

// First-fit of class cls on the staged row by one warp, booking every
// share into `row`; returns whether every wanted pick found a card.  The
// picks of a container that is inactive, or past its GPU count, are not
// wanted: they book nothing and do not fail the fit.
__device__ bool fit_row(const Args& a, long long* row, const long long* cap, const bool* present,
                        const bool* card_ok, const int* order, int cls) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int ti = 0; ti < a.TC; ++ti) {
    const long long at = static_cast<long long>(cls) * a.TC + ti;
    const int gpus = a.container_active[at] ? a.num_gpus[at] : 0;
    for (int ki = 0; ki < a.K && ki < gpus; ++ki) {
      bool fit[2];
      int key = INT_MAX;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int c = lane + 32 * s;
        fit[s] = c < a.C && card_ok[c] && card_fits(a, row, cap, present, c, cls, ti);
        if (c < a.C) key = min(key, fit[s] ? order[c] : BIG_ORDER);
      }
      const int best = __reduce_min_sync(FULL, key);
      int mine = INT_MAX;
#pragma unroll
      for (int s = 1; s >= 0; --s) {
        const int c = lane + 32 * s;
        if (c < a.C && fit[s] && order[c] == best) mine = c;
      }
      const int chosen = __reduce_min_sync(FULL, mine);
      if (chosen == INT_MAX) {
        ok = false;
        continue;
      }
      if ((chosen & 31) == lane) {
        const long long base = at * a.R;
        for (int r = 0; r < a.R; ++r)
          if (a.need_active[base + r]) row[chosen * a.R + r] += a.need[base + r];
      }
      __syncwarp();
    }
  }
  return ok;
}

__global__ void __launch_bounds__(THREADS) fused_schedule_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ long long smem[];
  long long* row = smem;  // [C * R] the booked node's amounts
  long long* scratch = row + a.C * a.R;  // [C * R] a refit's amounts
  long long* cap = scratch + a.C * a.R;  // [R]
  int* order = reinterpret_cast<int*>(cap + a.R);  // [C]
  bool* present = reinterpret_cast<bool*>(order + a.C);  // [R]
  bool* card_ok = present + a.R;  // [C]
  __shared__ Best warp_bests[WARPS];
  __shared__ Best winner;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, T = a.T, CR = a.C * a.R;
  const int begin = blockIdx.x * a.chunk;
  const int end = min(N, begin + a.chunk);

  // this block's chunk of the state, into the outputs it owns
  for (int n = begin + tid; n < end; n += THREADS) {
    a.capacity_left[n] = a.capacity[n];
    for (int t = 0; t < T; ++t) a.fits[static_cast<long long>(t) * N + n] = a.fits0[static_cast<long long>(t) * N + n];
  }
  for (long long i = static_cast<long long>(begin) * CR + tid; i < static_cast<long long>(end) * CR; i += THREADS)
    a.used_out[i] = a.used[i];
  __syncthreads();

  for (long long p = 0; p < a.P; ++p) {
    const int cls = a.req_class[p];
    const long long* score = a.score + p * N;
    const bool* eligible = a.eligible + p * N;
    const bool* fits = a.fits + static_cast<long long>(cls) * N;
    Best best{LLONG_MIN, NONE};
    for (int n = begin + tid; n < end; n += THREADS) {
      // four loads issued together, none waiting on another's value
      const bool e = eligible[n], f = fits[n];
      const int room = a.capacity_left[n];
      const long long s = score[n];
      if (e && f && room > 0 && (best.node == NONE || s > best.score)) best = Best{s, n};  // n rises: ties keep the first
    }
    best = warp_best(best);
    if (lane == 0) warp_bests[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < WARPS ? warp_bests[lane] : Best{LLONG_MIN, NONE};
      best = warp_best(best);
      if (lane == 0) {
        const int slot = static_cast<int>(p & 1) * gridDim.x + blockIdx.x;
        __stcg(a.partial_score + slot, best.score);
        __stcg(a.partial_node + slot, best.node);
      }
    }
    grid.sync();
    if (warp == 0) {
      best = Best{LLONG_MIN, NONE};
      for (int b = lane; b < gridDim.x; b += 32) {
        const int slot = static_cast<int>(p & 1) * gridDim.x + b;
        const Best other{__ldcg(a.partial_score + slot), __ldcg(a.partial_node + slot)};
        if (before(other, best)) best = other;
      }
      best = warp_best(best);
      if (lane == 0) winner = best;
    }
    __syncthreads();
    const int node = winner.node;
    if (blockIdx.x == 0 && tid == 0) a.node_for_pod[p] = node == NONE ? -1 : node;
    if (node == NONE || node < begin || node >= end) continue;  // uniform over the block

    // the owner books the node with warp 0
    if (warp == 0) {
      long long* used_n = a.used_out + static_cast<long long>(node) * CR;
      for (int i = lane; i < CR; i += 32) row[i] = used_n[i];
      for (int r = lane; r < a.R; r += 32) {
        cap[r] = a.gas_capacity[static_cast<long long>(node) * a.R + r];
        present[r] = a.cap_present[static_cast<long long>(node) * a.R + r];
      }
      for (int c = lane; c < a.C; c += 32) {
        const long long at = static_cast<long long>(node) * a.C + c;
        card_ok[c] = a.card_valid[at] && a.card_real[at];
        order[c] = a.card_order[at];
      }
      __syncwarp();
      fit_row(a, row, cap, present, card_ok, order, cls);  // the fits gate: it takes the whole request
      for (int i = lane; i < CR; i += 32) used_n[i] = row[i];
      for (int t = 0; t < T; ++t) {
        for (int i = lane; i < CR; i += 32) scratch[i] = row[i];
        __syncwarp();
        const bool ok = fit_row(a, scratch, cap, present, card_ok, order, t);
        if (lane == 0) a.fits[static_cast<long long>(t) * N + node] = ok;
        __syncwarp();
      }
      if (lane == 0) a.capacity_left[node] -= 1;
    }
    __syncthreads();
  }
}

int blocks_for(int N) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return -1;
  // at least 32 nodes a block: a small problem does not pay for idle blocks
  const int wanted = (N + 31) / 32;
  return wanted < sms ? wanted : sms;
}

size_t shared_bytes(int C, int R) {
  return static_cast<size_t>(2 * C * R + R) * sizeof(long long) + C * sizeof(int) + R + C;
}

}  // namespace

extern "C" {

// Largest C (cards a node), Tc (containers a class) and C x R the kernel takes.
int fused_schedule_max_cards() { return MAX_CARDS; }
int fused_schedule_max_containers() { return MAX_CONTAINERS; }
int fused_schedule_max_row() { return MAX_ROW; }

// Blocks a launch at N nodes runs (one an SM at most), -1 on a CUDA error:
// the partials buffer holds 2 x this many of each of int64 and int32.
int fused_schedule_blocks(int N) { return blocks_for(N); }

// One cooperative launch on `stream`; returns the CUDA error (0 =
// launched).  score int64 [P, N], eligible bool [P, N], capacity int32 [N],
// req_class int32 [P] (each in [0, T)), fits0 bool [T, N], used int64
// [N, C, R], gas_capacity int64 [N, R], cap_present bool [N, R], card_valid
// and card_real bool [N, C], card_order int32 [N, C], need int64 [T, Tc, R],
// need_active bool [T, Tc, R], num_gpus int32 [T, Tc], container_active
// bool [T, Tc]; writes node_for_pod int32 [P], capacity_left int32 [N],
// used_out int64 [N, C, R] and fits bool [T, N].  P > 0, N > 0, T > 0,
// 0 < C <= max_cards, Tc <= max_containers, C x R <= max_row.
int fused_schedule_launch(const void* score, const void* eligible, const void* capacity, const void* req_class,
                          const void* fits0, const void* used, const void* gas_capacity, const void* cap_present,
                          const void* card_valid, const void* card_real, const void* card_order, const void* need,
                          const void* need_active, const void* num_gpus, const void* container_active,
                          void* node_for_pod, void* capacity_left, void* used_out, void* fits,
                          void* partial_score, void* partial_node, long long P, int N, int C, int R, int T,
                          int TC, int K, void* stream) {
  const int blocks = blocks_for(N);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const long long*>(score),
         static_cast<const bool*>(eligible),
         static_cast<const int*>(capacity),
         static_cast<const int*>(req_class),
         static_cast<const bool*>(fits0),
         static_cast<const long long*>(used),
         static_cast<const long long*>(gas_capacity),
         static_cast<const bool*>(cap_present),
         static_cast<const bool*>(card_valid),
         static_cast<const bool*>(card_real),
         static_cast<const int*>(card_order),
         static_cast<const long long*>(need),
         static_cast<const bool*>(need_active),
         static_cast<const int*>(num_gpus),
         static_cast<const bool*>(container_active),
         static_cast<int*>(node_for_pod),
         static_cast<int*>(capacity_left),
         static_cast<long long*>(used_out),
         static_cast<bool*>(fits),
         static_cast<long long*>(partial_score),
         static_cast<int*>(partial_node),
         P, N, C, R, T, TC, K,
         (N + blocks - 1) / blocks};
  void* params[] = {&a};
  const cudaError_t err =
      cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_schedule_kernel), dim3(blocks), dim3(THREADS),
                                  params, shared_bytes(C, R), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
