// K3: median filter along the last axis, reflect padding, odd width <= 13.
//
// Replaces whisper_tpu/ops/kernels/median_pallas.py:median_filter_pallas
// (body _median_kernel).  Same function: out[r, t] is the median of
// x[r, t - w/2 .. t + w/2] with numpy's "reflect" padding (index -1 reads
// 1, index T reads T - 2); the caller passes T > w / 2, so one reflection
// covers every window.
//
// What bounds it on an H100: one read and one write of 4 bytes per output
// (the w - 1 neighbours come from L1), ~123 MB at the word-timing shape
// (40 x 1 x 256 x 1500 f32, width 7), which alone would take ~0.04 ms; the
// 21 compare-exchanges of 64-bit keys per output (w = 7) take longer, so
// integer issue bounds it (0.24 ms on an H100 80GB HBM3 at 700 W).
//
// Design: the TPU kernel sorts w shifted copies of a block of rows with an
// odd-even transposition network.  Here one thread computes one output: it
// gathers its window into registers and runs the same network (w rounds of
// compare-exchange).  It sorts what the JAX package's stable jnp.sort
// sorts: each value's key is its IEEE order as an integer (the
// sign-magnitude bits folded into two's complement) after -0 is made +0
// and every NaN the one canonical NaN (which sorts last), and equal keys
// keep their window order, because the key carries the window position in
// its low 4 bits.  The output is the original value at the middle rank, so
// it is bit-equal to the sort's, -0 versus +0 included.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ long long sort_key(float x, int position) {
  const int bits = x == 0.f ? 0 : (isnan(x) ? 0x7fc00000 : __float_as_int(x));
  return (long long)(bits ^ ((bits >> 31) & 0x7fffffff)) * 16 + position;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
median_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int T) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= n) return;
  const long long row = idx / T;
  const int t = (int)(idx - row * T);
  const float* xr = x + row * T;
  constexpr int PAD = W / 2;
  float val[W];
  long long key[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    int s = t + k - PAD;
    s = s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s);
    val[k] = xr[s];
    key[k] = sort_key(val[k], k);
  }
#pragma unroll
  for (int round = 0; round < W; ++round) {
#pragma unroll
    for (int i = round & 1; i < W - 1; i += 2) {
      const long long lo = min(key[i], key[i + 1]);
      key[i + 1] = max(key[i], key[i + 1]);
      key[i] = lo;
    }
  }
  const int position = (int)(key[PAD] & 15);
  float median = val[0];
#pragma unroll
  for (int k = 1; k < W; ++k)
    if (position == k) median = val[k];
  out[idx] = median;
}

template <int W>
void launch(const float* x, float* out, long long n, int T, cudaStream_t stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  median_kernel<W><<<(unsigned)blocks, THREADS, 0, stream>>>(x, out, n, T);
}

}  // namespace

// x, out: (rows, T) f32, contiguous
extern "C" int median_filter(const void* x, void* out, long long rows, int T, int width,
                             void* stream) {
  const long long n = rows * T;
  if (rows <= 0 || T <= width / 2 || n / 256 >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: launch<1>(xp, op, n, T, s); break;
    case 3: launch<3>(xp, op, n, T, s); break;
    case 5: launch<5>(xp, op, n, T, s); break;
    case 7: launch<7>(xp, op, n, T, s); break;
    case 9: launch<9>(xp, op, n, T, s); break;
    case 11: launch<11>(xp, op, n, T, s); break;
    case 13: launch<13>(xp, op, n, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
