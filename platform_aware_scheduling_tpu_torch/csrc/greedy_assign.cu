// Greedy capacity-constrained assignment: one thread block on Hopper.
//
// Replaces the TPU kernel platform_aware_scheduling_tpu/ops/pallas_assign.py
// (_kernel, launched by _build_call, wrapped by greedy_assign_pallas) and
// computes exactly what it and ops/assign.greedy_assign_kernel compute: for
// each pod p in order, the node n with the largest int64 score[p, n] among
// lanes with eligible[p, n] && capacity[n] > 0, ties to the lowest n; that
// node's capacity then drops by one.  node_for_pod[p] is -1 when no lane is
// ok, and the capacity is then left untouched.
//
// Design.  The pods are P dependent steps over one capacity vector, so the
// whole solve is one block of THREADS threads that loops over pods and keeps
// the [N] int32 capacity in dynamic shared memory for the entire launch (the
// counterpart of the TPU kernel's VMEM scratch).  Per pod every thread scans
// its strided lanes, keeping its best (score, index); a warp-shuffle
// reduction and a cross-warp pass through shared memory keep the larger
// score and, on equal scores, the lower index.  Thread 0 writes the result
// and decrements the chosen capacity, and a barrier publishes it to the
// next pod.  Native int64 compares replace the TPU kernel's (hi, lo ^ 2^31)
// split.  "Found" is "some lane was ok" (the index is a real lane), never
// "max > sentinel", so an eligible lane scoring INT64_MIN is still chosen.
//
// Bound.  The function must read score (8 bytes) and eligible (1 byte) for
// every pod and node, and read and write the capacity once: P*N*9 + 8*N
// bytes (+ 4*P for the output), about 90 MB at 1000 x 10000, which is
// about 27 us at the H100's 3.35 TB/s.  One block streams through ONE SM,
// whose load bandwidth is a small fraction of the card's, and each pod pays
// two block barriers; this kernel sits far above that bound.  A design that
// spreads the rows over many SMs (a thread-block cluster sharing the
// capacity through distributed shared memory, TMA-streamed score rows) is
// later work.
//
// Shared memory limits N: 4*N bytes of capacity must fit the block's opt-in
// maximum (227 KB on the H100, about 58k nodes); greedy_assign_max_nodes
// reports the exact limit and the Python wrapper refuses larger N.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int NONE = INT_MAX;  // "no ok lane"; every real lane index is < N

// Is candidate (s, i) better than the current (bs, bi)?  A real lane beats
// NONE; a larger score wins; on equal scores the lower index wins.
__device__ __forceinline__ bool better(long long s, int i, long long bs, int bi) {
  if (i == NONE) return false;
  if (bi == NONE) return true;
  return s > bs || (s == bs && i < bi);
}

__device__ __forceinline__ void warp_best(long long& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long s = __shfl_down_sync(0xffffffffu, bs, off);
    const int i = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
greedy_assign_kernel(const long long* __restrict__ score,
                     const unsigned char* __restrict__ eligible,
                     const int* __restrict__ capacity,
                     int* __restrict__ node_for_pod,
                     int* __restrict__ capacity_left, int P, int N) {
  extern __shared__ int cap[];  // [N]
  __shared__ long long warp_score[WARPS];
  __shared__ int warp_index[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int n = tid; n < N; n += THREADS) cap[n] = capacity[n];
  __syncthreads();

  for (int p = 0; p < P; ++p) {
    const long long* row = score + static_cast<size_t>(p) * N;
    const unsigned char* ok_row = eligible + static_cast<size_t>(p) * N;
    long long bs = LLONG_MIN;
    int bi = NONE;
    // lanes ascend within a thread, so strict '>' keeps the lowest index;
    // the score is loaded without waiting on the mask so the loads of
    // several unrolled lanes are in flight together
#pragma unroll 4
    for (int n = tid; n < N; n += THREADS) {
      const long long s = row[n];
      const bool ok = ok_row[n] != 0 && cap[n] > 0;
      if (ok && (bi == NONE || s > bs)) {
        bs = s;
        bi = n;
      }
    }
    warp_best(bs, bi);
    if (lane == 0) {
      warp_score[warp] = bs;
      warp_index[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = warp_score[lane];  // WARPS == 32: one entry per lane
      bi = warp_index[lane];
      warp_best(bs, bi);
      if (lane == 0) {
        if (bi != NONE) {
          cap[bi] -= 1;
          node_for_pod[p] = bi;
        } else {
          node_for_pod[p] = -1;
        }
      }
    }
    __syncthreads();
  }

  for (int n = tid; n < N; n += THREADS) capacity_left[n] = cap[n];
}

static_assert(WARPS == 32, "the cross-warp pass reads one entry per lane");

}  // namespace

extern "C" {

// Largest N whose capacity vector fits the block's shared memory on
// `device`, or -1 on a CUDA error.
int greedy_assign_max_nodes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, greedy_assign_kernel) != cudaSuccess)
    return -1;
  return static_cast<int>((static_cast<size_t>(optin) - attr.sharedSizeBytes) /
                          sizeof(int));
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
// Pointers are device pointers: score int64 [P, N], eligible uint8/bool
// [P, N], capacity int32 [N]; outputs node_for_pod int32 [P] and
// capacity_left int32 [N].  P and N are positive.
int greedy_assign_launch(const void* score, const void* eligible,
                         const void* capacity, void* node_for_pod,
                         void* capacity_left, int P, int N, void* stream) {
  const size_t smem = static_cast<size_t>(N) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  greedy_assign_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(score),
      static_cast<const unsigned char*>(eligible),
      static_cast<const int*>(capacity), static_cast<int*>(node_for_pod),
      static_cast<int*>(capacity_left), P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
