// Batched Holt forecast fit on Hopper, over the forecaster's history ring:
// a thread per (metric, node) series, the node index fastest across a warp.
//
// Replaces platform_aware_scheduling_tpu/ops/forecast.py _forecast_kernel
// (an XLA jit of a lax.scan over the history window that updates every
// series at once) and computes exactly what it, the JAX package's numpy
// forecast_host and the port's ops/forecast.forecast_reference compute on
// the staging ops/state.build_history_tensor makes of the same rings.  For
// each series, over its W samples oldest first, a valid sample past the
// first does
//
//   err   = x - (L + b)        adj = err >> 1
//   L'    = L + b + adj        b'  = b + (adj >> 2)
//   acc  += |err|
//
// the first valid sample seeds L = x, b = 0, and an invalid slot carries
// the state through.  Then resid = floor(acc / max(count - 1, 1)),
// predicted = L + b * h and band = resid * (1 + h).
//
// Input.  The ring (ops/state.HistoryRing) as it lies on the card: raw
// milli values int64 [M, W, N] and valid bytes [M, W, N], head int32 [M]
// (row m's oldest sample is in slot head[m], so step i reads slot
// (head[m] + i) % W) and shift int32 [M].  A sample is x = raw >> shift[m],
// arithmetic, truncated to its low 32 bits: what numpy's astype(np.int32)
// gives after the staging's shift, an INT64_MIN sample included.  The
// host stages only each refit's new samples into their slots, so the
// shift, which depends on every sample of the row, is applied here and
// not at staging.  Columns from n_live on hold no node: they write the
// zero result without reading the ring.  ops/cuda_forecast.forecast_cuda
// feeds the JAX package's [M, N, W] int32 staging through this kernel too,
// widened and permuted on the card, with head 0 and shift 0.
//
// Bits.  XLA's int32 sums wrap, and the JAX package's parity test draws
// values in +-2^30, so wrap-around is normal input.  In C++ a signed
// overflow is undefined, so every sum and product is formed in uint32_t
// and read back as int32_t (two's complement).  >> of a negative signed
// integer is an arithmetic shift with nvcc, as XLA's and numpy's are.
// |INT32_MIN| is 0 - INT32_MIN in uint32_t, which reads back as INT32_MIN,
// as jnp.abs and np.abs give.  acc may have wrapped negative, and XLA's and
// numpy's // floor where C's / truncates, so the quotient steps down by one
// where a negative acc leaves a remainder (the divisor is >= 1).
//
// Bound: bytes.  The function reads a valid byte for each slot of the live
// columns, 8 bytes for each valid sample, head and shift, and writes six
// int32 planes [6, M, N] (24 bytes a series).  At the main path's
// 8 x 32 x 16384 ring with 10,000 live columns and full rings that is
// 26,185,792 bytes, 0.0078 ms at 3.35 TB/s; it does ~12 integer operations
// a sample, far below the card's rates.  The thread-per-row kernel this
// replaces read the [M, N, W] int32 staging with the shift done on the host
// (17,580,032 bytes) but its warp touched 32 lines a load, rows W * 4 bytes
// apart, and reached 0.22 of that bound.
//
// Design.  In step i the warp's 32 threads read 32 neighbouring columns of
// one slot: 256 contiguous bytes of values and 32 of valid, so every load
// coalesces.  The loads do not depend on the recurrence, so each thread
// starts a batch of BATCH steps' loads into registers (valid first, then
// the values where valid is set) before it folds them in: 8 steps keep 16
// loads in flight a thread at 48 registers, so the SM keeps its full
// complement of warps (at 8 x 16384 series, 512 blocks, ~4 an SM), and
// those warps' batches together cover the memory latency.  A double-
// buffered shared-memory tile (cp.async) would buy the same overlap with
// more code: each value is read once, so shared memory would hold nothing
// a second thread reads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ALPHA_SHIFT = 1;
constexpr int BETA_SHIFT = 2;
constexpr int THREADS = 256;
constexpr int BATCH = 8;

__device__ __forceinline__ int32_t wrap(uint32_t x) { return static_cast<int32_t>(x); }

__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return wrap(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return wrap(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t mul32(int32_t a, int32_t b) {
  return wrap(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t abs32(int32_t a) { return a < 0 ? sub32(0, a) : a; }

// floor(a / d) for d >= 1
__device__ __forceinline__ int32_t floor_div(int32_t a, int32_t d) {
  int32_t q = a / d;
  if (a < 0 && q * d != a) --q;
  return q;
}

// the low 32 bits of raw >> shift, arithmetic
__device__ __forceinline__ int32_t descale(int64_t raw, int shift) {
  return wrap(static_cast<uint32_t>(static_cast<uint64_t>(raw >> shift)));
}

__global__ void __launch_bounds__(THREADS)
    forecast_ring_kernel(const int64_t* __restrict__ values, const uint8_t* __restrict__ valid,
                         const int32_t* __restrict__ head, const int32_t* __restrict__ shift,
                         int32_t* __restrict__ out, int M, int W, int N, int n_live, int horizon,
                         int blocks_per_row) {
  const int m = blockIdx.x / blocks_per_row;
  const int n = (blockIdx.x % blocks_per_row) * THREADS + threadIdx.x;
  if (n >= N) return;
  int32_t level = 0, trend = 0, count = 0, acc = 0;
  if (n < n_live) {
    const int first = __ldg(head + m);
    const int sh = min(max(__ldg(shift + m), 0), 63);
    const long long row = static_cast<long long>(m) * W * N + n;
    const int64_t* x = values + row;
    const uint8_t* v = valid + row;
    for (int base = 0; base < W; base += BATCH) {
      uint8_t ok[BATCH];
      int64_t raw[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        ok[k] = 0;
        if (base + k < W) {
          int slot = first + base + k;
          if (slot >= W) slot -= W;
          ok[k] = __ldg(v + static_cast<long long>(slot) * N);
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        raw[k] = 0;
        if (ok[k]) {
          int slot = first + base + k;
          if (slot >= W) slot -= W;
          raw[k] = __ldg(x + static_cast<long long>(slot) * N);
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (!ok[k]) continue;
        const int32_t xt = descale(raw[k], sh);
        if (count == 0) {
          level = xt;
          trend = 0;
        } else {
          const int32_t pred1 = add32(level, trend);
          const int32_t err = sub32(xt, pred1);
          const int32_t adj = err >> ALPHA_SHIFT;
          level = add32(pred1, adj);
          trend = add32(trend, adj >> BETA_SHIFT);
          acc = add32(acc, abs32(err));
        }
        ++count;
      }
    }
  }
  const long long series = static_cast<long long>(M) * N;
  const long long s = static_cast<long long>(m) * N + n;
  const int32_t resid = floor_div(acc, count > 2 ? count - 1 : 1);
  out[s] = level;
  out[series + s] = trend;
  out[2 * series + s] = resid;
  out[3 * series + s] = add32(level, mul32(trend, horizon));
  out[4 * series + s] = mul32(resid, add32(1, horizon));
  out[5 * series + s] = count;
}

}  // namespace

extern "C" {

// One launch on `stream` over the M x N series of a ring of W slots;
// returns cudaGetLastError() (0 = launched).
int forecast_ring_launch(const void* values, const void* valid, const void* head, const void* shift, void* out,
                         int M, int W, int N, int n_live, int horizon, void* stream) {
  if (M < 0 || W < 0 || N < 0 || n_live < 0 || n_live > N) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const int blocks_per_row = (N + THREADS - 1) / THREADS;
  const long long blocks = static_cast<long long>(M) * blocks_per_row;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  forecast_ring_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values), static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(head),
      static_cast<const int32_t*>(shift), static_cast<int32_t*>(out), M, W, N, n_live, horizon, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
