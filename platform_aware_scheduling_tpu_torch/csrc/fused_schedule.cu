// The fused TAS+GAS solve's scan over the pods on Hopper: a candidate pass
// over every SM, then an in-order resolve in one block.
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
// Why the split is exact.  A pod's starting-ok lanes are eligible[p] &
// capacity_in > 0 & fits0[class[p]].  Rank lanes by (score descending,
// index ascending), a total order.  Capacity only goes down, and a node's
// fits change only when that node is booked.  But first-fit over several
// resources is not monotone in usage: a booking can turn a node's fit for
// another class back on (three cards of room (10, 10) booked (0, 0),
// (10, 10), (0, 5): a class asking (1, 5) then (0, 8) does not fit until
// (10, 0) is booked on the first card).  So a node that is ok for pod p now
// is either one of its starting-ok lanes or a node whose fit for p's class
// turned from false to true since the start.  The revival rule: whenever a
// refit turns class t on for node n, n joins class t's revived list
// (unless it is on it already); a pod of class t drops the listed nodes
// that are no longer ok for the class and weighs those still ok and
// eligible for it.  Then for pod p of class t:
//  - if any entry of its list of the L best starting-ok lanes is still ok,
//    the first such entry is the best ok starting-ok lane (a starting-ok
//    lane not on the list ranks below every entry), and the answer is the
//    better of it and the best revived node;
//  - if none is ok and the list held every starting-ok lane, the answer is
//    the best revived node, or -1;
//  - if none is ok and the row had more than L starting-ok lanes, or the
//    class's revived list overflowed (REVIVED nodes), the whole block
//    rescans the row against the current capacity and fits: exact.
// resolve_kernel counts the rescans and the revivals (turns of a class fit
// from false to true).
//
// Stage 1, candidates_kernel: one block of 128 threads per pod row, so the
// rows spread over every SM and each byte is read once, in parallel.  Each
// warp keeps the sorted top L of the lanes it has seen in registers, four
// entries a lane (lane l holds entries 4l .. 4l+3), so an insertion shifts
// the list with one shuffle; a lane that ranks below the warp's L-th entry
// is dropped with one compare, and each thread offers its best lane of a
// batch first, so the threshold rises early.  The four warp lists merge by
// rank (each entry's position in its own list plus a binary search in each
// other list), which gives the exact top min(L, count) of the row, since
// every lane of the row's top L is in its own warp's top L.  The pass writes
// lists [P, L] and the count of starting-ok lanes [P], and copies the usage
// into used_out, which the resolve books into.
//
// Stage 2, resolve_kernel: one block of 512 threads holds the capacity
// (int32 [N]) and the fits ([T, N] bytes; bit 0 the fit, bit 1 "on the
// class's revived list") in dynamic shared memory, and stages the class
// tables there once.  A pod costs two block barriers.  Before the first,
// warp 0 picks the node (the pod's list, prefetched into shared memory by
// warp 1 during the previous pod, walked 32 entries a ballot; then the
// revived nodes).  After it, where a node's C x R amounts fit one warp
// (24 on the main path), each of T warps reads the node's amounts, room
// and cards into registers, one (card, resource) pair a lane, books the
// pod's class first-fit itself (the same picks in every warp) and refits
// one class on its copy; a pick is then a compare, a ballot (a card fits
// when none of its R lanes fails) and two warp minima.  Wider nodes take
// one more barrier: warp 0 books the row in shared memory, a lane per
// card, and the T warps refit copies of it.  The refit warps update the
// fits and the revived lists; the second barrier ends the pod, and warp 0
// writes the booked row back.  A rescan costs two more barriers.  The
// outputs are written at the end from shared memory.
//
// L = 128.  On BASELINE config #4 at full size (seed 21, 10,000 nodes x
// 1,000 pods) every class fits every node at the start; each pod's winner
// lies at position 28 of its starting list at the median and 72 at most,
// none past 128, so the resolve needs no rescan there, where the greedy
// kernel's 16 would rescan most pods.  A longer list costs stage 1 more
// insertions for each row.  L / 4 = 32, so a list is one int4 a lane.
//
// Shared memory limits N: N x (T + 4) bytes of capacity and fits, plus the
// class tables (T x Tc x R x 9 + T x Tc x 4), T x REVIVED x 4 of revived
// lists, the booked row and one copy a refit warp (C x R x 8 each) and two
// lists must fit the resolve block's opt-in maximum (227 KB on the H100:
// about 32,400 nodes at the main path's T = 3, Tc = 2, C = 8, R = 3, well
// above the mirror's 16,384; 75 KB at 10,000 nodes).  fused_schedule_max_nodes reports the exact limit for
// a shape and the Python wrapper refuses larger N.
//
// Bound: bytes.  The function must read score int64 [P, N], eligible
// [P, N], capacity int32 [N], req_class int32 [P], fits0 [T, N], used int64
// [N, C, R], capacity int64 [N, R], cap_present [N, R], card_valid and
// card_real [N, C], card_order int32 [N, C] and the classes, and write
// node_for_pod int32 [P], capacity_left int32 [N], used and fits: at
// 1000 x 10,000 with 8 cards, 3 resources and 3 classes, about 94.7 MB,
// 0.028 ms at 3.35 TB/s.  Stage 1 reads the 90 MB of rows across the card
// (0.38 ms on an H100 at 700 W); the resolve's chain of 1,000 dependent
// pods reads a few hundred bytes each, and its time is that chain's
// latency (2.5 us a pod: the node's global read, two first-fit passes of
// up to four dependent picks, two barriers).

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int L = 128;              // list length
constexpr int PER_LANE = L / 32;    // list entries a lane holds
constexpr int REVIVED = 256;        // revived-list room of a class
constexpr int CAND_THREADS = 128;   // stage 1: one block per pod row
constexpr int CAND_WARPS = CAND_THREADS / 32;
constexpr int BATCH = 4;            // stage 1: row lanes a thread loads at once
constexpr int THREADS = 512;        // stage 2: one block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CARDS = 64;
constexpr int MAX_CONTAINERS = 16;
constexpr int MAX_ROW = 2048;       // C x R amounts of a node
constexpr int BIG_ORDER = 1 << 30;  // the key of a card that does not fit
constexpr int NONE = INT_MAX;       // no lane; every real lane index is < N
constexpr int RESCAN = -2;          // the pod's row is rescanned by the block
constexpr unsigned char FIT = 1;    // a fits byte: the class fits the node
constexpr unsigned char LISTED = 2; // a fits byte: the node is on the class's revived list

static_assert(L == 128 && PER_LANE == 4, "a list is one int4 a lane of a warp");
static_assert(WARPS <= 32, "the rescan's cross-warp pass reads one entry per lane");

// Is candidate (s, i) better than the current (bs, bi)?  A real lane beats
// NONE; a larger score wins; on equal scores the lower index wins.
__device__ __forceinline__ bool better(long long s, int i, long long bs, int bi) {
  if (i == NONE) return false;
  if (bi == NONE) return true;
  return s > bs || (s == bs && i < bi);
}

// The warp's best (score, index); every lane gets it.
__device__ __forceinline__ void warp_best(long long& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long s = __shfl_xor_sync(FULL, bs, off);
    const int i = __shfl_xor_sync(FULL, bi, off);
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
  }
}

// The warp's sorted top-L list: lane l holds entries PER_LANE * l + j in
// (es[j], ei[j]), NONE-padded; (ts, ti) is entry L - 1, the threshold a lane
// must beat to enter.
struct WarpList {
  long long es[PER_LANE];
  int ei[PER_LANE];
  long long ts;
  int ti;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      es[j] = LLONG_MIN;
      ei[j] = NONE;
    }
    ts = LLONG_MIN;
    ti = NONE;
  }

  // Warp-collective: insert every lane's (s, n) for which `cand` holds and
  // which beats the threshold.  Insertion order does not matter: the list
  // is the top L of the set offered.
  __device__ __forceinline__ void offer(bool cand, long long s, int n, int lane) {
    cand = cand && better(s, n, ts, ti);
    unsigned pending = __ballot_sync(FULL, cand);
    while (pending) {
      const int src = __ffs(pending) - 1;
      const long long cs = __shfl_sync(FULL, s, src);
      const int ci = __shfl_sync(FULL, n, src);
      // the entries the candidate beats are a suffix of the sorted list,
      // never empty, since the candidate beats entry L - 1
      int beaten = 0;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) beaten += better(cs, ci, es[j], ei[j]);
      const int first = __ffs(__ballot_sync(FULL, beaten > 0)) - 1;
      const int pos = PER_LANE * first + PER_LANE - __shfl_sync(FULL, beaten, first);
      const long long carry_s = __shfl_up_sync(FULL, es[PER_LANE - 1], 1);
      const int carry_i = __shfl_up_sync(FULL, ei[PER_LANE - 1], 1);
#pragma unroll
      for (int j = PER_LANE - 1; j >= 0; --j) {
        const int at = PER_LANE * lane + j;
        if (at > pos) {
          es[j] = j > 0 ? es[j - 1] : carry_s;
          ei[j] = j > 0 ? ei[j - 1] : carry_i;
        } else if (at == pos) {
          es[j] = cs;
          ei[j] = ci;
        }
      }
      ts = __shfl_sync(FULL, es[PER_LANE - 1], 31);
      ti = __shfl_sync(FULL, ei[PER_LANE - 1], 31);
      if (lane == src) cand = false;
      cand = cand && better(s, n, ts, ti);
      pending = __ballot_sync(FULL, cand);
    }
  }
};

// Stage 1.  Block p writes lists[p, 0:min(L, count)] (the exact best
// starting-ok lanes in rank order) and counts[p] (all starting-ok lanes),
// and copies its share of the usage into used_out.
__global__ void __launch_bounds__(CAND_THREADS)
candidates_kernel(const long long* __restrict__ score, const bool* __restrict__ eligible,
                  const int* __restrict__ capacity, const int* __restrict__ req_class,
                  const bool* __restrict__ fits0, const long long* __restrict__ used,
                  long long* __restrict__ used_out, long long used_size, int* __restrict__ lists,
                  int* __restrict__ counts, int N) {
  __shared__ long long list_score[CAND_WARPS][L];
  __shared__ int list_index[CAND_WARPS][L];
  __shared__ int warp_count[CAND_WARPS];

  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (long long i = static_cast<long long>(p) * CAND_THREADS + tid; i < used_size;
       i += static_cast<long long>(gridDim.x) * CAND_THREADS)
    used_out[i] = used[i];

  const size_t row0 = static_cast<size_t>(p) * N;
  const long long* row = score + row0;
  const bool* ok_row = eligible + row0;
  const bool* fit = fits0 + static_cast<size_t>(req_class[p]) * N;

  WarpList list;
  list.init();
  int seen = 0;
  // warp w takes lanes base .. base + 32 * BATCH - 1, lane-contiguous in
  // each of its BATCH loads; the loop bound is warp-uniform
  for (int base = warp * 32 * BATCH; base < N; base += CAND_THREADS * BATCH) {
    bool ok[BATCH];
    long long s[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int n = base + 32 * j + lane;
      bool e = false, f = false;
      int room = 0;
      long long v = 0;
      if (n < N) {  // four loads issued together, none waiting on another's value
        e = ok_row[n];
        f = fit[n];
        room = capacity[n];
        v = row[n];
      }
      ok[j] = e && f && room > 0;
      s[j] = v;
    }
    bool any = false;
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      seen += ok[j];
      any = any || (ok[j] && better(s[j], base + 32 * j + lane, list.ts, list.ti));
    }
    if (__any_sync(FULL, any)) {
      // each thread's best lane first: the threshold rises before the
      // other lanes are offered, so fewer of them are inserted; j rises
      // with the lane index, so strict '>' keeps the lowest on a tie
      int best = -1;
      long long best_s = 0;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        if (ok[j] && (best < 0 || s[j] > best_s)) {
          best = j;
          best_s = s[j];
        }
      }
      list.offer(best >= 0, best_s, base + 32 * best + lane, lane);
#pragma unroll
      for (int j = 0; j < BATCH; ++j) list.offer(ok[j] && j != best, s[j], base + 32 * j + lane, lane);
    }
  }

#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    list_score[warp][PER_LANE * lane + j] = list.es[j];
    list_index[warp][PER_LANE * lane + j] = list.ei[j];
  }
  seen = __reduce_add_sync(FULL, seen);
  if (lane == 0) warp_count[warp] = seen;
  __syncthreads();

  int total = 0;
#pragma unroll
  for (int w = 0; w < CAND_WARPS; ++w) total += warp_count[w];
  int* out = lists + static_cast<size_t>(p) * L;
  // rank of each entry among all warp lists: its own position plus, in each
  // other (sorted) list, the number of entries that beat it
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    if (list.ei[j] == NONE) continue;
    int rank = PER_LANE * lane + j;
    for (int w = 0; w < CAND_WARPS; ++w) {
      if (w == warp) continue;
      int c = 0;
#pragma unroll
      for (int step = L; step > 0; step >>= 1) {
        if (c + step <= L && better(list_score[w][c + step - 1], list_index[w][c + step - 1], list.es[j], list.ei[j]))
          c += step;
      }
      rank += c;
    }
    if (rank < L) out[rank] = list.ei[j];
  }
  if (tid == 0) counts[p] = total;
}

// Where each array of the resolve block lives in its dynamic shared memory.
struct Layout {
  size_t need, row, scratch, node_cap;                       // int64
  size_t cap, revived, revived_count, gpus, order, list;     // int32
  size_t fits, need_active, present, card_ok, overflow;      // bytes
  size_t total;
};

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  at = (at + 15) / 16 * 16;
  const size_t offset = at;
  at += bytes;
  return offset;
}

__host__ __device__ inline int refit_warps(int T) { return T < WARPS ? T : WARPS; }

__host__ __device__ inline Layout layout(int N, int C, int R, int T, int TC) {
  const size_t n = static_cast<size_t>(N), cr = static_cast<size_t>(C) * R, t = static_cast<size_t>(T);
  const size_t classes = t * TC;
  Layout s{};
  size_t at = 0;
  s.need = take(at, 8 * classes * R);
  s.row = take(at, 8 * cr);
  s.scratch = take(at, 8 * cr * refit_warps(T));
  s.node_cap = take(at, 8 * static_cast<size_t>(R));
  s.cap = take(at, 4 * n);
  s.revived = take(at, 4 * t * REVIVED);
  s.revived_count = take(at, 4 * t);
  s.gpus = take(at, 4 * classes);
  s.order = take(at, 4 * static_cast<size_t>(C));
  s.list = take(at, 4 * 2 * static_cast<size_t>(L));
  s.fits = take(at, t * n);
  s.need_active = take(at, classes * R);
  s.present = take(at, R);
  s.card_ok = take(at, C);
  s.overflow = take(at, t);
  s.total = at;
  return s;
}

struct ResolveArgs {
  const long long* score;
  const bool* eligible;
  const int* capacity;
  const int* req_class;
  const bool* fits0;
  const long long* gas_capacity;
  const bool* cap_present;
  const bool* card_valid;
  const bool* card_real;
  const int* card_order;
  const long long* need;
  const bool* need_active;
  const int* num_gpus;
  const bool* container_active;
  const int* lists;
  const int* counts;
  int* node_for_pod;
  int* capacity_left;
  long long* used;  // used_out of stage 1, booked in place
  bool* fits;
  int* stats;  // [rescans, revivals]
  int P, N, C, R, T, TC, K;
};

// The class tables and the booked node's card state, in shared memory.
struct Tables {
  const long long* need;            // [T, Tc, R]
  const unsigned char* need_active; // [T, Tc, R]
  const int* gpus;                  // [T, Tc]: num_gpus, 0 for an inactive container
  const long long* cap;             // [R] the node's
  const unsigned char* present;     // [R]
  const unsigned char* card_ok;     // [C]
  const int* order;                 // [C]
  int C, R, TC, K;
};

// Whether card c of the row takes one share of container ti of class cls
// (the port's ops/binpack._card_fits for one card).
__device__ __forceinline__ bool card_fits(const Tables& s, const long long* row, int c, int cls, int ti) {
  const int base = (cls * s.TC + ti) * s.R;
  for (int r = 0; r < s.R; ++r) {
    if (!s.need_active[base + r]) continue;
    const long long need = s.need[base + r];
    const long long amount = row[c * s.R + r];
    if (!(need >= 0 && s.present[r] && s.cap[r] > 0 && amount >= 0 && amount <= s.cap[r] - need)) return false;
  }
  return true;
}

// First-fit of class cls on `row` by one warp, booking every share into
// `row`; returns whether every wanted pick found a card.  The picks of a
// container that is inactive, or past its GPU count, are not wanted: they
// book nothing and do not fail the fit.
__device__ bool fit_row(const Tables& s, long long* row, int cls) {
  const int lane = threadIdx.x & 31;
  bool ok = true;
  for (int ti = 0; ti < s.TC; ++ti) {
    const int at = cls * s.TC + ti;
    const int gpus = s.gpus[at];
    for (int ki = 0; ki < s.K && ki < gpus; ++ki) {
      bool fit[2];
      int key = INT_MAX;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        fit[h] = c < s.C && s.card_ok[c] && card_fits(s, row, c, cls, ti);
        if (c < s.C) key = min(key, fit[h] ? s.order[c] : BIG_ORDER);
      }
      const int best = __reduce_min_sync(FULL, key);
      int mine = INT_MAX;
#pragma unroll
      for (int h = 1; h >= 0; --h) {
        const int c = lane + 32 * h;
        if (c < s.C && fit[h] && s.order[c] == best) mine = c;
      }
      const int chosen = __reduce_min_sync(FULL, mine);
      if (chosen == INT_MAX) {
        ok = false;
        continue;
      }
      if ((chosen & 31) == lane) {
        const int base = at * s.R;
        for (int r = 0; r < s.R; ++r)
          if (s.need_active[base + r]) row[chosen * s.R + r] += s.need[base + r];
      }
      __syncwarp();
    }
  }
  return ok;
}

// One (card, resource) pair a lane, for nodes of at most 32 amounts: lane
// q < C x R holds card q / R's booked amount of resource q % R and what a
// pick needs of that card and resource, in registers.
struct PairLane {
  bool real;  // q < C x R
  int c, r;
  long long amount, cap;
  bool present, card_ok;
  int order;
};

__device__ __forceinline__ PairLane load_pair(const ResolveArgs& a, int node) {
  const int q = threadIdx.x & 31;
  PairLane x{q < a.C * a.R, 0, 0, 0, 0, false, false, 0};
  if (x.real) {  // six loads issued together, none waiting on another's value
    x.c = q / a.R;
    x.r = q % a.R;
    const size_t card = static_cast<size_t>(node) * a.C + x.c;
    const size_t resource = static_cast<size_t>(node) * a.R + x.r;
    x.amount = a.used[static_cast<size_t>(node) * a.C * a.R + q];
    x.cap = a.gas_capacity[resource];
    x.present = a.cap_present[resource];
    x.card_ok = a.card_valid[card] && a.card_real[card];
    x.order = a.card_order[card];
  }
  return x;
}

// fit_row's first-fit over pair lanes: a card fits when none of its R
// lanes fails (one ballot), so a pick is a compare, a ballot and two warp
// minima, with no memory traffic.  Books into `amount`.
__device__ bool fit_pairs(const Tables& s, const PairLane& x, long long& amount, int cls) {
  const unsigned group = (s.R >= 32 ? FULL : (1u << s.R) - 1u) << (x.c * s.R);
  bool ok = true;
  for (int ti = 0; ti < s.TC; ++ti) {
    const int at = cls * s.TC + ti;
    const int gpus = s.gpus[at];
    const bool active = x.real && s.need_active[at * s.R + x.r];
    const long long need = active ? s.need[at * s.R + x.r] : 0;
    const bool room = need >= 0 && x.present && x.cap > 0;
    for (int ki = 0; ki < s.K && ki < gpus; ++ki) {
      const bool fits = !active || (room && amount >= 0 && amount <= x.cap - need);
      const unsigned fail = __ballot_sync(FULL, x.real && !fits);
      const bool card = x.real && x.card_ok && !(fail & group);
      const int best = __reduce_min_sync(FULL, x.real ? (card ? x.order : BIG_ORDER) : INT_MAX);
      const int chosen = __reduce_min_sync(FULL, card && x.order == best ? x.c : INT_MAX);
      if (chosen == INT_MAX) {
        ok = false;
        continue;
      }
      if (active && x.c == chosen) amount += need;
    }
  }
  return ok;
}

// Lane 0 of a refit warp: the booked node's new fit for class k, and the
// revival rule; returns 1 for a revival (a fit turned from false to true).
__device__ __forceinline__ int record_fit(int k, int node, bool ok, int N, unsigned char* fits, int* revived,
                                          int* revived_count, unsigned char* overflow) {
  unsigned char& f = fits[static_cast<size_t>(k) * N + node];
  const bool revival = ok && !(f & FIT);
  if (revival && !(f & LISTED)) {
    if (revived_count[k] < REVIVED) {
      revived[k * REVIVED + revived_count[k]++] = node;
      f |= LISTED;
    } else {
      overflow[k] = 1;
    }
  }
  f = ok ? (f | FIT) : (f & static_cast<unsigned char>(~FIT));
  return revival;
}

// Warp 0: pod p's node from its list (`list`, `count` starting-ok lanes)
// and its class's revived nodes, -1, or RESCAN when only the whole row can
// tell.  Drops the revived nodes that are no longer ok for the class.
__device__ int choose(const ResolveArgs& a, int p, int cls, const int* list, int count, const int* cap,
                      unsigned char* fits, int* revived, int* revived_count, const unsigned char* overflow) {
  const int lane = threadIdx.x & 31;
  if (overflow[cls]) return RESCAN;
  const size_t row0 = static_cast<size_t>(p) * a.N;
  unsigned char* fit = fits + static_cast<size_t>(cls) * a.N;
  int* mine = revived + cls * REVIVED;
  const int listed = revived_count[cls];
  long long rs = LLONG_MIN;
  int ri = NONE;
  int kept = 0;
  for (int base = 0; base < listed; base += 32) {
    const int i = base + lane;
    const int node = i < listed ? mine[i] : 0;
    const bool keep = i < listed && cap[node] > 0 && (fit[node] & FIT);
    if (i < listed && !keep) fit[node] &= static_cast<unsigned char>(~LISTED);
    const unsigned mask = __ballot_sync(FULL, keep);
    __syncwarp();  // every lane has read its entry before the kept ones move down
    if (keep) {
      mine[kept + __popc(mask & ((1u << lane) - 1))] = node;
      if (a.eligible[row0 + node]) {
        const long long s = a.score[row0 + node];
        if (better(s, node, rs, ri)) {
          rs = s;
          ri = node;
        }
      }
    }
    kept += __popc(mask);
  }
  __syncwarp();
  if (listed) {
    if (lane == 0) revived_count[cls] = kept;
    warp_best(rs, ri);
  }

  const int m = min(count, L);
  int found = NONE;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    const int node = i < m ? list[i] : 0;
    const bool live = i < m && cap[node] > 0 && (fit[node] & FIT);
    const unsigned hit = __ballot_sync(FULL, live);
    if (hit) {
      found = __shfl_sync(FULL, node, __ffs(hit) - 1);
      break;
    }
  }
  if (found == NONE) {
    if (count > L) return RESCAN;
    return ri == NONE ? -1 : ri;
  }
  if (ri == NONE) return found;
  return better(rs, ri, a.score[row0 + found], found) ? ri : found;
}

// The whole block: pod p's best node over its whole row against the
// current capacity and fits of class cls, or -1.
__device__ int rescan(const ResolveArgs& a, int p, int cls, const int* cap, const unsigned char* fits,
                      long long* warp_score, int* warp_index, int* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(p) * a.N;
  const unsigned char* fit = fits + static_cast<size_t>(cls) * a.N;
  long long bs = LLONG_MIN;
  int bi = NONE;
  // lanes ascend within a thread, so strict '>' keeps the lowest index
#pragma unroll 4
  for (int n = tid; n < a.N; n += THREADS) {
    const long long s = a.score[row0 + n];
    const bool ok = a.eligible[row0 + n] && cap[n] > 0 && (fit[n] & FIT);
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
    bs = lane < WARPS ? warp_score[lane] : LLONG_MIN;
    bi = lane < WARPS ? warp_index[lane] : NONE;
    warp_best(bs, bi);
    if (lane == 0) *out = bi == NONE ? -1 : bi;
  }
  __syncthreads();
  return *out;
}

// Warp 1: pod q's list, count and class into slot q & 1 of the staging.
__device__ __forceinline__ void stage_pod(const ResolveArgs& a, int q, int* list_buf, int* pod_count,
                                          int* pod_class) {
  const int lane = threadIdx.x & 31;
  reinterpret_cast<int4*>(list_buf + (q & 1) * L)[lane] =
      reinterpret_cast<const int4*>(a.lists + static_cast<size_t>(q) * L)[lane];
  if (lane == 0) {
    pod_count[q & 1] = a.counts[q];
    pod_class[q & 1] = a.req_class[q];
  }
}

// Stage 2, one block: the pods in order (see the note at the top).
__global__ void __launch_bounds__(THREADS, 1) resolve_kernel(const ResolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout at = layout(a.N, a.C, a.R, a.T, a.TC);
  long long* need = reinterpret_cast<long long*>(smem + at.need);
  long long* row = reinterpret_cast<long long*>(smem + at.row);
  long long* scratch_all = reinterpret_cast<long long*>(smem + at.scratch);
  long long* node_cap = reinterpret_cast<long long*>(smem + at.node_cap);
  int* cap = reinterpret_cast<int*>(smem + at.cap);
  int* revived = reinterpret_cast<int*>(smem + at.revived);
  int* revived_count = reinterpret_cast<int*>(smem + at.revived_count);
  int* gpus = reinterpret_cast<int*>(smem + at.gpus);
  int* order = reinterpret_cast<int*>(smem + at.order);
  int* list_buf = reinterpret_cast<int*>(smem + at.list);  // [2, L]: this pod's list and the next's
  unsigned char* fits = smem + at.fits;
  unsigned char* need_active = smem + at.need_active;
  unsigned char* present = smem + at.present;
  unsigned char* card_ok = smem + at.card_ok;
  unsigned char* overflow = smem + at.overflow;
  __shared__ long long warp_score[WARPS];
  __shared__ int warp_index[WARPS];
  __shared__ int pod_node[2];  // by the pod's parity, so one pod's read and the next's write never meet
  __shared__ int rescan_node;
  __shared__ int pod_count[2], pod_class[2];
  __shared__ int revival_total;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, T = a.T, CR = a.C * a.R;
  const int classes = T * a.TC;
  const size_t TN = static_cast<size_t>(T) * N;
  const int refitters = refit_warps(T);
  const bool pairs = CR > 0 && CR <= 32;  // a node's amounts fit one warp's lanes

  for (int n = tid; n < N; n += THREADS) cap[n] = a.capacity[n];
  for (size_t i = tid; i < TN; i += THREADS) fits[i] = a.fits0[i] ? FIT : 0;
  for (int i = tid; i < classes * a.R; i += THREADS) {
    need[i] = a.need[i];
    need_active[i] = a.need_active[i];
  }
  for (int i = tid; i < classes; i += THREADS) gpus[i] = a.container_active[i] ? a.num_gpus[i] : 0;
  for (int t = tid; t < T; t += THREADS) {
    revived_count[t] = 0;
    overflow[t] = 0;
  }
  if (tid == 0) revival_total = 0;
  if (warp == 1) stage_pod(a, 0, list_buf, pod_count, pod_class);
  __syncthreads();

  const Tables tables{need, need_active, gpus, node_cap, present, card_ok, order, a.C, a.R, a.TC, a.K};
  int rescans = 0, revivals = 0;
  for (int p = 0; p < a.P; ++p) {
    const int buf = p & 1;
    const int cls = pod_class[buf];
    if (warp == 0) {
      const int node = choose(a, p, cls, list_buf + buf * L, pod_count[buf], cap, fits, revived, revived_count,
                              overflow);
      if (lane == 0) pod_node[buf] = node;
    } else if (warp == 1 && p + 1 < a.P) {
      stage_pod(a, p + 1, list_buf, pod_count, pod_class);
    }
    __syncthreads();
    int node = pod_node[buf];
    if (node == RESCAN) {  // uniform over the block
      node = rescan(a, p, cls, cap, fits, warp_score, warp_index, &rescan_node);
      if (tid == 0) ++rescans;
    }
    if (warp == 0 && lane == 0) a.node_for_pod[p] = node;
    if (node < 0) continue;  // uniform; nothing is booked

    long long booked = 0;  // pair lanes: this lane's booked amount
    if (pairs) {
      // each refit warp reads the node and books it itself (the same
      // first-fit, so the same amounts), then refits its classes
      if (warp < refitters) {
        const PairLane x = load_pair(a, node);
        booked = x.amount;
        fit_pairs(tables, x, booked, cls);  // the fits gate: it takes the whole request
        if (warp == 0 && lane == 0) cap[node] -= 1;
        for (int k = warp; k < T; k += refitters) {
          long long amount = booked;
          const bool ok = fit_pairs(tables, x, amount, k);
          if (lane == 0) revivals += record_fit(k, node, ok, N, fits, revived, revived_count, overflow);
        }
      }
    } else {
      // warp 0 books the node's row in shared memory
      if (warp == 0) {
        long long* used_n = a.used + static_cast<size_t>(node) * CR;
        for (int i = lane; i < CR; i += 32) row[i] = used_n[i];
        for (int r = lane; r < a.R; r += 32) {
          node_cap[r] = a.gas_capacity[static_cast<size_t>(node) * a.R + r];
          present[r] = a.cap_present[static_cast<size_t>(node) * a.R + r];
        }
        for (int c = lane; c < a.C; c += 32) {
          const size_t k = static_cast<size_t>(node) * a.C + c;
          card_ok[c] = a.card_valid[k] && a.card_real[k];
          order[c] = a.card_order[k];
        }
        __syncwarp();
        fit_row(tables, row, cls);  // the fits gate: it takes the whole request
        for (int i = lane; i < CR; i += 32) used_n[i] = row[i];
        if (lane == 0) cap[node] -= 1;
      }
      __syncthreads();
      // T warps refit the node's classes, each on its own copy of the booked row
      if (warp < refitters) {
        long long* scratch = scratch_all + warp * CR;
        for (int k = warp; k < T; k += refitters) {
          for (int i = lane; i < CR; i += 32) scratch[i] = row[i];
          __syncwarp();
          const bool ok = fit_row(tables, scratch, k);
          if (lane == 0) revivals += record_fit(k, node, ok, N, fits, revived, revived_count, overflow);
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // the booked row goes back once no warp of this pod reads it
    if (pairs && warp == 0 && lane < CR) a.used[static_cast<size_t>(node) * CR + lane] = booked;
  }

  if (lane == 0 && revivals) atomicAdd(&revival_total, revivals);
  __syncthreads();
  for (int n = tid; n < N; n += THREADS) a.capacity_left[n] = cap[n];
  for (size_t i = tid; i < TN; i += THREADS) a.fits[i] = (fits[i] & FIT) != 0;
  if (tid == 0) {
    a.stats[0] = rescans;
    a.stats[1] = revival_total;
  }
}

int max_shared(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, resolve_kernel) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

}  // namespace

extern "C" {

// Length of each pod's candidate list (the lists scratch is [P, L] int32)
// and the room of a class's revived list.
int fused_schedule_list_size() { return L; }
int fused_schedule_revived_size() { return REVIVED; }

// Largest C (cards a node), Tc (containers a class) and C x R the kernel takes.
int fused_schedule_max_cards() { return MAX_CARDS; }
int fused_schedule_max_containers() { return MAX_CONTAINERS; }
int fused_schedule_max_row() { return MAX_ROW; }

// Dynamic shared memory the resolve block needs at this shape, in bytes.
long long fused_schedule_shared_bytes(int N, int C, int R, int T, int TC) {
  return static_cast<long long>(layout(N, C, R, T, TC).total);
}

// Dynamic shared memory the resolve block may use on `device`, or -1 on a
// CUDA error.
int fused_schedule_max_shared(int device) { return max_shared(device); }

// Largest N whose resolve block fits `device` at C, R, T, Tc: 0 when none,
// -1 on a CUDA error.
int fused_schedule_max_nodes(int device, int C, int R, int T, int TC) {
  const long long avail = max_shared(device);
  if (avail < 0) return -1;
  long long lo = 0, hi = INT_MAX;
  while (lo < hi) {  // the largest N in [0, INT_MAX] with total(N) <= avail
    const long long mid = lo + (hi - lo + 1) / 2;
    if (static_cast<long long>(layout(static_cast<int>(mid), C, R, T, TC).total) <= avail)
      lo = mid;
    else
      hi = mid - 1;
  }
  return static_cast<int>(lo);
}

// Stage 1 on `stream`; returns cudaGetLastError() (0 = launched).  score
// int64 [P, N], eligible bool [P, N], capacity int32 [N], req_class int32
// [P] (each in [0, T)), fits0 bool [T, N], used int64 [N, C, R]; writes lists
// int32 [P, L], counts int32 [P] and used_out int64 [N, C, R].  P, N > 0.
int fused_schedule_candidates_launch(const void* score, const void* eligible, const void* capacity,
                                     const void* req_class, const void* fits0, const void* used, void* used_out,
                                     void* lists, void* counts, int P, int N, int C, int R, void* stream) {
  candidates_kernel<<<P, CAND_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(score), static_cast<const bool*>(eligible), static_cast<const int*>(capacity),
      static_cast<const int*>(req_class), static_cast<const bool*>(fits0), static_cast<const long long*>(used),
      static_cast<long long*>(used_out), static_cast<long long>(N) * C * R, static_cast<int*>(lists),
      static_cast<int*>(counts), N);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 on `stream`; returns the CUDA error (0 = launched).  Reads stage
// 1's lists and counts, books into used_out (int64 [N, C, R], stage 1's
// copy of the usage); gas_capacity int64 [N, R], cap_present bool [N, R],
// card_valid and card_real bool [N, C], card_order int32 [N, C], need int64
// [T, Tc, R], need_active bool [T, Tc, R], num_gpus int32 [T, Tc],
// container_active bool [T, Tc]; writes node_for_pod int32 [P],
// capacity_left int32 [N], fits bool [T, N] and stats int32 [2] (rescans,
// revivals).  0 < C <= max_cards, Tc <= max_containers, C x R <= max_row,
// N <= max_nodes.
int fused_schedule_resolve_launch(const void* score, const void* eligible, const void* capacity,
                                  const void* req_class, const void* fits0, const void* gas_capacity,
                                  const void* cap_present, const void* card_valid, const void* card_real,
                                  const void* card_order, const void* need, const void* need_active,
                                  const void* num_gpus, const void* container_active, const void* lists,
                                  const void* counts, void* node_for_pod, void* capacity_left, void* used_out,
                                  void* fits, void* stats, int P, int N, int C, int R, int T, int TC, int K,
                                  void* stream) {
  const size_t smem = layout(N, C, R, T, TC).total;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const ResolveArgs a{static_cast<const long long*>(score),
                      static_cast<const bool*>(eligible),
                      static_cast<const int*>(capacity),
                      static_cast<const int*>(req_class),
                      static_cast<const bool*>(fits0),
                      static_cast<const long long*>(gas_capacity),
                      static_cast<const bool*>(cap_present),
                      static_cast<const bool*>(card_valid),
                      static_cast<const bool*>(card_real),
                      static_cast<const int*>(card_order),
                      static_cast<const long long*>(need),
                      static_cast<const bool*>(need_active),
                      static_cast<const int*>(num_gpus),
                      static_cast<const bool*>(container_active),
                      static_cast<const int*>(lists),
                      static_cast<const int*>(counts),
                      static_cast<int*>(node_for_pod),
                      static_cast<int*>(capacity_left),
                      static_cast<long long*>(used_out),
                      static_cast<bool*>(fits),
                      static_cast<int*>(stats),
                      P, N, C, R, T, TC, K};
  resolve_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
