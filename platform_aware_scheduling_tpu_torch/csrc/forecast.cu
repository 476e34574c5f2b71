// Batched Holt forecast fit on Hopper: a thread per (metric, node) series.
//
// Replaces platform_aware_scheduling_tpu/ops/forecast.py _forecast_kernel
// (an XLA jit of a lax.scan over the history window that updates every
// series at once) and computes exactly what it, the JAX package's numpy
// forecast_host and the port's ops/forecast.forecast_reference compute.
// For each series, over its W samples oldest first, a valid sample past
// the first does
//
//   err   = x - (L + b)        adj = err >> 1
//   L'    = L + b + adj        b'  = b + (adj >> 2)
//   acc  += |err|
//
// the first valid sample seeds L = x, b = 0, and an invalid slot carries
// the state through.  Then resid = floor(acc / max(count - 1, 1)),
// predicted = L + b * h and band = resid * (1 + h).
//
// Bits.  XLA's int32 sums wrap, and the JAX package's parity test draws
// values in +-2^30, so wrap-around is normal input.  In C++ a signed
// overflow is undefined, so every sum and product is formed in uint32_t
// and read back as int32_t (two's complement).  >> of a negative int32_t
// is an arithmetic shift with nvcc, as XLA's and numpy's are.  |INT32_MIN|
// is 0 - INT32_MIN in uint32_t, which reads back as INT32_MIN, as
// jnp.abs and np.abs give.  acc may have wrapped negative, and XLA's and
// numpy's // floor where C's / truncates, so the quotient steps down by
// one where a negative acc leaves a remainder (the divisor is >= 1).
//
// Layout.  The staging is the JAX package's [M, N, W]: values int32,
// valid bool (one byte), a series' W samples contiguous.  Thread s walks
// series s's row, keeping L, b, count and acc in registers, and writes its
// six results at s of the six [M, N] planes of `out` ([6, M, N] int32:
// level, trend, resid, predicted, band, samples), so the wrapper reads all
// six back in one copy.
//
// Bound: bytes.  The function reads valid (1 byte) for every slot, values
// (4 bytes) only where valid is set, and writes 24 bytes per series: at
// the main path's 8 x 16384 x 32 with 10,000 nodes' full rings (the
// padding columns never valid), 17,580,032 bytes, 0.0052 ms at 3.35 TB/s.
// It does ~10 integer operations a sample, far below the card's rates.  What holds
// this version back: neighbouring threads read rows W * 4 bytes apart
// (128 bytes at W = 32), so a warp's load touches 32 lines and the loads
// do not coalesce; each line is reused for the next samples from L1 while
// it stays resident.  A staging transposed to [M, W, N], or a block that
// copies its rows through shared memory, would coalesce them: later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ALPHA_SHIFT = 1;
constexpr int BETA_SHIFT = 2;
constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS)
    forecast_kernel(const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
                    int32_t* __restrict__ out, long long series, int W, int horizon) {
  const long long s = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (s >= series) return;
  const int32_t* x = values + s * W;
  const uint8_t* v = valid + s * W;
  int32_t level = 0, trend = 0, count = 0, acc = 0;
  for (int t = 0; t < W; ++t) {
    if (!__ldg(v + t)) continue;
    const int32_t xt = __ldg(x + t);
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

// One launch on `stream` over `series` = M * N series of W samples;
// returns cudaGetLastError() (0 = launched).
int forecast_launch(const void* values, const void* valid, void* out, long long series, int W, int horizon,
                    void* stream) {
  if (series < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (series == 0) return 0;
  const long long blocks = (series + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  forecast_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), static_cast<const uint8_t*>(valid), static_cast<int32_t*>(out), series,
      W, horizon);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
