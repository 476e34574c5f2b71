// Greedy capacity-constrained assignment on Hopper: a candidate pass over
// the whole card, then a short in-order resolve in one block.
//
// Replaces the TPU kernel platform_aware_scheduling_tpu/ops/pallas_assign.py
// (_kernel, launched by _build_call, wrapped by greedy_assign_pallas) and
// computes exactly what it and ops/assign.greedy_assign_kernel compute: for
// each pod p in order, the node n with the largest int64 score[p, n] among
// lanes with eligible[p, n] && capacity[n] > 0, ties to the lowest n; that
// node's capacity then drops by one.  node_for_pod[p] is -1 when no lane is
// ok, and the capacity is then left untouched.
//
// Why the split is exact.  Capacity only goes down, so the lanes that are ok
// for pod p are a subset of its starting-ok lanes (eligible[p] &&
// capacity_in > 0).  Rank lanes by (score descending, index ascending), a
// total order.  If any lane of a prefix of pod p's starting-ok lanes in that
// order still has capacity, the first such lane is exactly the greedy
// choice.  Only when every listed lane is used up and the row had more
// starting-ok lanes than the list holds is a full rescan against the current
// capacity needed; when the list held them all, the pod gets -1.
//
// Stage 1, candidates_kernel: one block of 128 threads per pod row, so the
// rows spread over every SM and each byte is read once, in parallel.  Each
// warp keeps the sorted top K of the lanes it has seen in registers, one
// entry per lane of the warp; a lane that ranks below the warp's K-th entry
// is dropped with one compare, and the rare lane that ranks above it is
// inserted with a ballot and a shuffle.  Each thread offers its best lane
// first, so the threshold rises before the rest are offered.  The four warp
// lists then merge by rank (each entry's position in its own list plus a
// binary search in each other list), which gives the exact top min(K, count)
// of the row, since every lane of the row's top K is in its own warp's top
// K.  The pass writes lists [P, K] and the count of starting-ok lanes [P].
// Its cost beyond the bytes is the insertions, about K*ln(M/K) per warp for
// M lanes in random order, so fewer, wider warps per row and a short list
// are cheaper.
//
// Stage 2, resolve_kernel: one block of 1024 threads holds the [N] int32
// capacity in dynamic shared memory.  Warp 0 walks the pods in order, 32 at
// a time, one pod per lane: each lane picks the first node of its pod's
// list that has capacity, __match_any_sync counts the earlier pods of the
// batch that picked the same node, and the pods up to the first whose node
// would run out are committed in order (see walk); __syncwarp is the walk's
// only synchronisation.  Only at a pod whose list is used up while the row
// had more ok lanes does it hand the pod to the whole block, which scans
// that row against the current capacity (strided scan, warp shuffle,
// cross-warp pass) between block barriers.  So block barriers are paid per
// rescan, not per pod; resolve_kernel counts the rescans.
//
// K = 16.  The pods of one policy share a score row and fill its best nodes
// in turn, so a pod needs more list than the nodes its predecessors used up:
// at the main path's inputs (110-pod nodes, 250 pods per policy) a few.  A
// longer list costs stage 1 more insertions for each row; a shorter one
// rescans sooner when many pods share a row and nodes hold few pods.  K is a
// multiple of 4, so the resolve reads a list as int4s.
//
// Bound: bytes.  The function must read the whole eligible mask, the score
// of every eligible lane, the capacity, and write the result and the
// capacity left: at the main path's 1000 x 16384 (10,000 real nodes) about
// 76 MB, ~0.023 ms at 3.35 TB/s.  Stage 1 loads a pair's scores only where
// the mask has an eligible lane in it, so padding columns cost only their
// mask bytes; the capacity it reads (64 KB) stays in cache.
//
// Alignment.  A row starts at lane offset p*N, so for odd N or N not a
// multiple of 8 the rows start at any alignment.  Each row is cut into a
// scalar head up to the first lane whose offset is a multiple of 8, a body
// of 8-lane octets (one 8-byte mask load and up to four 16-byte score loads
// each, all aligned), and a scalar tail.  Base pointers that are not 16-byte
// (score) or 8-byte (mask) aligned take the scalar path for the whole row.
//
// Shared memory limits N: 4*N bytes of capacity must fit the resolve block's
// opt-in maximum (227 KB on the H100, 58,016 nodes); greedy_assign_max_nodes
// reports the exact limit and the Python wrapper refuses larger N.  Stage 1
// has no limit of its own.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K = 16;                // list length
constexpr int CAND_THREADS = 128;    // stage 1: one block per pod row
constexpr int CAND_WARPS = CAND_THREADS / 32;
constexpr int THREADS = 1024;        // stage 2: one block
constexpr int WARPS = THREADS / 32;
constexpr int NONE = INT_MAX;        // "no lane"; every real lane index is < N

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
    const long long s = __shfl_down_sync(FULL, bs, off);
    const int i = __shfl_down_sync(FULL, bi, off);
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
}

// The warp's sorted top-K list: lane j holds entry j (es, ei), NONE-padded;
// (ts, ti) is entry K-1, the threshold a lane must beat to enter.
struct WarpList {
  long long es = LLONG_MIN;
  int ei = NONE;
  long long ts = LLONG_MIN;
  int ti = NONE;

  // Warp-collective: insert every lane's (s, n) for which `cand` holds and
  // which beats the threshold.  Insertion order does not matter: the list
  // is the top K of the set offered.
  __device__ __forceinline__ void offer(bool cand, long long s, int n, int lane) {
    cand = cand && better(s, n, ts, ti);
    unsigned pending = __ballot_sync(FULL, cand);
    while (pending) {
      const int src = __ffs(pending) - 1;
      const long long cs = __shfl_sync(FULL, s, src);
      const int ci = __shfl_sync(FULL, n, src);
      // the entries the candidate beats are a suffix of the sorted list,
      // never empty, since the candidate beats entry K-1
      const int pos = __ffs(__ballot_sync(FULL, better(cs, ci, es, ei))) - 1;
      const long long us = __shfl_up_sync(FULL, es, 1);
      const int ui = __shfl_up_sync(FULL, ei, 1);
      if (lane == pos) {
        es = cs;
        ei = ci;
      } else if (lane > pos) {
        es = us;
        ei = ui;
      }
      ts = __shfl_sync(FULL, es, K - 1);
      ti = __shfl_sync(FULL, ei, K - 1);
      if (lane == src) cand = false;
      cand = cand && better(s, n, ts, ti);
      pending = __ballot_sync(FULL, cand);
    }
  }
};

static_assert(K % 4 == 0 && K <= 32, "a warp list holds one entry per lane; "
              "the resolve reads a list as int4s");

// Stage 1.  Block p writes lists[p, 0:min(K, count)] (the exact best
// starting-ok lanes in rank order) and counts[p] (all starting-ok lanes).
__global__ void __launch_bounds__(CAND_THREADS)
candidates_kernel(const long long* __restrict__ score,
                  const unsigned char* __restrict__ eligible,
                  const int* __restrict__ capacity, int* __restrict__ lists,
                  int* __restrict__ counts, int N, bool aligned) {
  __shared__ long long list_score[CAND_WARPS][K];
  __shared__ int list_index[CAND_WARPS][K];
  __shared__ int warp_count[CAND_WARPS];

  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row0 = static_cast<size_t>(p) * N;
  const long long* row = score + row0;
  const unsigned char* ok_row = eligible + row0;

  WarpList list;
  int seen = 0;

  // lanes [lo, hi) one at a time; the loop bound is warp-uniform
  auto scalar_lanes = [&](int lo, int hi) {
    for (int base = lo + warp * 32; base < hi; base += CAND_THREADS) {
      const int n = base + lane;
      const bool ok = n < hi && ok_row[n] != 0 && capacity[n] > 0;
      const long long s = ok ? row[n] : 0;
      seen += ok;
      list.offer(ok, s, n, lane);
    }
  };

  // head: scalar lanes up to the first lane offset that is a multiple of 8
  int head = aligned ? static_cast<int>((8 - (row0 & 7)) & 7) : N;
  if (head > N) head = N;
  const int octets = (N - head) / 8;
  const int body_end = head + octets * 8;
  scalar_lanes(0, head);

  // body: octet q covers lanes head + 8q .. +7; neighbouring threads take
  // neighbouring octets
  const int stride = CAND_THREADS;
  int q = warp * 32 + lane;
  uint2 mask = q < octets ? *reinterpret_cast<const uint2*>(ok_row + head + 8 * q)
                          : make_uint2(0, 0);
  for (int q0 = warp * 32; q0 < octets; q0 += stride, q += stride) {
    const int n = head + 8 * q;
    const uint2 m = mask;
    const int qn = q + stride;
    mask = qn < octets ? *reinterpret_cast<const uint2*>(ok_row + head + 8 * qn)
                       : make_uint2(0, 0);
    long long s[8];
    bool ok[8];
#pragma unroll
    for (int pair = 0; pair < 4; ++pair) {
      const unsigned word = pair < 2 ? m.x : m.y;
      const unsigned bits = word >> (16 * (pair & 1));
      const bool e0 = (bits & 0xffu) != 0;
      const bool e1 = (bits & 0xff00u) != 0;
      longlong2 v = make_longlong2(0, 0);
      if (e0 || e1) v = *reinterpret_cast<const longlong2*>(row + n + 2 * pair);
      ok[2 * pair] = e0 && capacity[n + 2 * pair] > 0;
      ok[2 * pair + 1] = e1 && capacity[n + 2 * pair + 1] > 0;
      s[2 * pair] = v.x;
      s[2 * pair + 1] = v.y;
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      seen += ok[j];
      any = any || (ok[j] && better(s[j], n + j, list.ts, list.ti));
    }
    if (__ballot_sync(FULL, any)) {
      // each thread's best lane first: the threshold rises before the
      // other lanes are offered, so fewer of them are inserted
      int best = -1;
      long long best_s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (ok[j] && (best < 0 || s[j] > best_s)) {
          best = j;
          best_s = s[j];
        }
      }
      list.offer(best >= 0, best_s, n + best, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) list.offer(ok[j] && j != best, s[j], n + j, lane);
    }
  }
  scalar_lanes(body_end, N);

  if (lane < K) {
    list_score[warp][lane] = list.es;
    list_index[warp][lane] = list.ei;
  }
  seen = __reduce_add_sync(FULL, seen);
  if (lane == 0) warp_count[warp] = seen;
  __syncthreads();

  // rank of this lane's entry among all warp lists: its own position plus,
  // in each other (sorted) list, the number of entries that beat it
  if (lane < K && list.ei != NONE) {
    int rank = lane;
    for (int w = 0; w < CAND_WARPS; ++w) {
      if (w == warp) continue;
      int c = 0;
#pragma unroll
      for (int step = 32; step > 0; step >>= 1) {
        if (c + step <= K &&
            better(list_score[w][c + step - 1], list_index[w][c + step - 1], list.es,
                   list.ei))
          c += step;
      }
      rank += c;
    }
    if (rank < K) lists[static_cast<size_t>(p) * K + rank] = list.ei;
  }
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < CAND_WARPS; ++w) total += warp_count[w];
    counts[p] = total;
  }
}

// Stage 2, warp 0: resolve pods from `p` in order until one needs a rescan;
// returns that pod, or P when every pod is resolved.  Lane j takes pod
// p + j of a batch of 32: its pick is the first node of its list with
// capacity at the batch's start.  Going through the batch in order, each
// pick is the greedy choice as long as every earlier pick was and the
// node's capacity exceeds the number of earlier pods of the batch that
// picked it (__match_any_sync): capacity only went down for the listed
// nodes before the pick.  The prefix of pods up to the first that fails
// this, or needs a rescan, is committed, and the next batch starts there.
__device__ int walk(int p, const int* __restrict__ lists, const int* __restrict__ counts,
                    int* cap, int* __restrict__ node_for_pod, int P, int lane) {
  const unsigned before_me = (1u << lane) - 1;
  while (p < P) {
    const int q = p + lane;
    const bool real = q < P;
    const int count = real ? counts[q] : 0;
    int entry[K];
#pragma unroll
    for (int v = 0; v < K / 4; ++v) {
      const int4 x = real ? reinterpret_cast<const int4*>(lists + static_cast<size_t>(q) * K)[v]
                          : make_int4(0, 0, 0, 0);
      entry[4 * v] = x.x;
      entry[4 * v + 1] = x.y;
      entry[4 * v + 2] = x.z;
      entry[4 * v + 3] = x.w;
    }
    int pick = -1;
#pragma unroll
    for (int i = K - 1; i >= 0; --i)
      if (i < count && cap[entry[i]] > 0) pick = entry[i];
    const int earlier = __popc(__match_any_sync(FULL, pick) & before_me);
    const bool holds = pick < 0 ? count <= K : cap[pick] > earlier;
    const unsigned stops = __ballot_sync(FULL, !real || !holds);
    const int commit = stops ? __ffs(stops) - 1 : 32;
    if (lane < commit) {
      node_for_pod[q] = pick;
      if (pick >= 0) atomicSub(&cap[pick], 1);
    }
    __syncwarp();
    p += commit;
    // the first pod that did not hold needs a rescan when its whole list
    // was used up at the batch's start; otherwise it leads the next batch
    if (commit < 32 && p < P && __shfl_sync(FULL, pick < 0, commit)) return p;
  }
  return P;
}

__global__ void __launch_bounds__(THREADS, 1)
resolve_kernel(const long long* __restrict__ score,
               const unsigned char* __restrict__ eligible,
               const int* __restrict__ capacity, const int* __restrict__ lists,
               const int* __restrict__ counts, int* __restrict__ node_for_pod,
               int* __restrict__ capacity_left, int* __restrict__ rescans, int P, int N) {
  extern __shared__ int cap[];  // [N]
  __shared__ long long warp_score[WARPS];  // warp_score[0] also hands over the pod to rescan
  __shared__ int warp_index[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int n = tid; n < N; n += THREADS) cap[n] = capacity[n];
  __syncthreads();

  int done = 0;
  for (int p = 0;; ++p, ++done) {
    if (warp == 0) {
      const int stop = walk(p, lists, counts, cap, node_for_pod, P, lane);
      if (lane == 0) warp_score[0] = stop;
    }
    __syncthreads();
    p = static_cast<int>(warp_score[0]);
    __syncthreads();  // every thread has read the pod before warp_score is reused
    if (p >= P) break;

    // the whole row of pod p against the current capacity
    const long long* row = score + static_cast<size_t>(p) * N;
    const unsigned char* ok_row = eligible + static_cast<size_t>(p) * N;
    long long bs = LLONG_MIN;
    int bi = NONE;
    // lanes ascend within a thread, so strict '>' keeps the lowest index
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
  if (tid == 0) *rescans = done;
}

static_assert(WARPS == 32, "the cross-warp pass reads one entry per lane");

}  // namespace

extern "C" {

// Length of each pod's candidate list (the lists scratch is [P, K] int32).
int greedy_assign_list_size() { return K; }

// Largest N whose capacity vector fits the resolve block's shared memory
// on `device`, or -1 on a CUDA error.
int greedy_assign_max_nodes(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, resolve_kernel) != cudaSuccess) return -1;
  return static_cast<int>((static_cast<size_t>(optin) - attr.sharedSizeBytes) /
                          sizeof(int));
}

// Stage 1 on `stream`; returns cudaGetLastError() (0 = launched).  score
// int64 [P, N], eligible uint8/bool [P, N], capacity int32 [N]; writes lists
// int32 [P, K] and counts int32 [P].  P and N are positive.
int greedy_assign_candidates_launch(const void* score, const void* eligible,
                                    const void* capacity, void* lists, void* counts,
                                    int P, int N, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(score) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(eligible) % 8 == 0;
  candidates_kernel<<<P, CAND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(score), static_cast<const unsigned char*>(eligible),
      static_cast<const int*>(capacity), static_cast<int*>(lists),
      static_cast<int*>(counts), N, aligned);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 on `stream`; returns cudaGetLastError() (0 = launched).  Reads
// stage 1's lists and counts; writes node_for_pod int32 [P], capacity_left
// int32 [N] and rescans int32 [1].
int greedy_assign_resolve_launch(const void* score, const void* eligible,
                                 const void* capacity, const void* lists,
                                 const void* counts, void* node_for_pod,
                                 void* capacity_left, void* rescans, int P, int N,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(N) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  resolve_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(score), static_cast<const unsigned char*>(eligible),
      static_cast<const int*>(capacity), static_cast<const int*>(lists),
      static_cast<const int*>(counts), static_cast<int*>(node_for_pod),
      static_cast<int*>(capacity_left), static_cast<int*>(rescans), P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
