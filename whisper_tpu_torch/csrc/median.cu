// K3: median filter along the last axis, reflect padding, odd width <= 13.
//
// Replaces whisper_tpu/ops/kernels/median_pallas.py:median_filter_pallas
// (body _median_kernel).  Same function: out[r, t] is the median of
// x[r, t - w/2 .. t + w/2] with numpy's "reflect" padding (index -1 reads
// 1, index T reads T - 2); the caller passes T > w / 2, so one reflection
// covers every window.  Each window is ordered as the JAX package's stable
// jnp.sort orders it: by IEEE value with -0 equal to +0 and every NaN last
// and equal, equal keys in window order; the output is the original value
// at the middle rank, so it is bit-equal to the sort's, -0 against +0 and
// NaN payloads included.
//
// What bounds it on an H100: one read and one write of 4 bytes per output,
// ~123 MB at the word-timing shape (40 x 1 x 256 x 1500 f32, width 7),
// 0.037 ms at 3.35 TB/s; the selection below takes ~20 integer
// instructions an output, under that.
//
// Design: the TPU kernel sorts w shifted copies of a block of rows with an
// odd-even transposition network.  Here a block of 128 threads takes a
// tile of 512 outputs of one row: it loads the tile and its w - 1 halo
// values (16-byte loads where the tile starts on a 16-byte boundary) and
// turns each value into a 32-bit key once, into shared memory: the
// sign-magnitude bits folded into two's complement, after -0 -> +0 and
// every NaN -> the canonical NaN, so that native 32-bit min/max compare in
// jnp.sort's order.  A thread takes 4 consecutive outputs, two pairs.  The
// windows of outputs t and t + 1 share w - 1 values: those are sorted once
// (Batcher's merge-exchange network; only the two middle ranks are kept,
// the compiler drops the rest), and each output's median is its own extra
// value clamped between them: rank w/2 of the sorted shared values plus
// one is max(s[w/2 - 1], min(e, s[w/2])).  Equal keys only tie values
// that differ where the median key is 0 or NaN: then the thread counts the
// window's smaller keys and takes the value of the right one of the equal
// keys in window order (their values staged beside the keys), as the
// stable sort would.
// Outputs leave as 16-byte stores where the tile is aligned.

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int V = 4;                  // outputs a thread
constexpr int TILE = THREADS * V;     // outputs a block
constexpr int NAN_KEY = 0x7fc00000;   // the canonical NaN's key (the fold keeps it)

__device__ __forceinline__ int sort_key(float v) {
  const int bits = v == 0.f ? 0 : (isnan(v) ? NAN_KEY : __float_as_int(v));
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// the key's value: the fold is its own inverse (keys 0 and NAN_KEY stand
// for several values, which the caller resolves)
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

__device__ __forceinline__ int reflect(int s, int T) { return s < 0 ? -s : (s >= T ? 2 * (T - 1) - s : s); }

// ceil(lg n) for n >= 2: the number of values p takes in Algorithm M below
__host__ __device__ constexpr int ceil_lg(int n) {
  int t = 0;
  while ((1 << t) < n) ++t;
  return t;
}

// Sort a[0..N) ascending (N >= 2): Batcher's merge-exchange (Knuth, TAOCP
// 5.2.2, Algorithm M), which sorts any N; p runs over 2^(t-1) .. 1 and, for
// each, q over 2^(t-1) .. p.  Fully unrolled, so the indices are constants
// and a[] lives in registers
template <int N>
__device__ __forceinline__ void sort_net(int* a) {
  constexpr int T = ceil_lg(N), TOP = 1 << (T - 1);
#pragma unroll
  for (int pi = 0; pi < T; ++pi) {
    const int p = TOP >> pi;
#pragma unroll
    for (int qi = 0; qi <= pi; ++qi) {
      const int q = TOP >> qi;
      const int d = qi == 0 ? p : 2 * q - p, r = qi == 0 ? 0 : p;
#pragma unroll
      for (int i = 0; i + d < N; ++i) {
        if ((i & p) == r) {
          const int lo = min(a[i], a[i + d]);
          a[i + d] = max(a[i], a[i + d]);
          a[i] = lo;
        }
      }
    }
  }
}

// the output whose window's keys are k[0..W) (window order), its values
// vals[0..W) in shared memory, and whose median key is med
template <int W>
__device__ __forceinline__ float median_value(const int* k, int med, const float* vals) {
  if (med != 0 && med != NAN_KEY) return key_value(med);  // one value has this key
  int less = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) less += k[j] < med;
  int q = W / 2 - less;  // the median is the q-th of the equal keys, in window order
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (k[j] == med) {
      if (q == 0) v = vals[j];
      --q;
    }
  }
  return v;
}

template <int W>
__global__ void __launch_bounds__(THREADS)
median_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int tiles) {
  constexpr int P = W / 2;
  constexpr int OFF = (P + 3) / 4 * 4;          // the tile starts at keys[OFF], 16-byte aligned
  constexpr int NK = (OFF + V + P + 3) / 4 * 4;  // the keys a thread reads, whole int4s
  __shared__ __align__(16) int keys[TILE + 16];  // key of row position t0 - OFF + u at u
  __shared__ __align__(16) float vals[TILE + 16];  // its value (the ties of keys 0 and NaN)
  const long long row = blockIdx.x / tiles;
  const int t0 = (int)(blockIdx.x - row * tiles) * TILE, tid = threadIdx.x;
  const float* xr = x + row * T;
  float* outr = out + row * T;
  const int tend = min(t0 + TILE, T);  // the tile's outputs: [t0, tend)

  // the tile's values, 16-byte loads where it starts on a 16-byte boundary
  const bool aligned = (reinterpret_cast<uintptr_t>(xr + t0) & 15) == 0;
  if (aligned && t0 + V * (tid + 1) <= tend) {
    const float4 v = *reinterpret_cast<const float4*>(xr + t0 + V * tid);
    *reinterpret_cast<int4*>(keys + OFF + V * tid) =
        make_int4(sort_key(v.x), sort_key(v.y), sort_key(v.z), sort_key(v.w));
    *reinterpret_cast<float4*>(vals + OFF + V * tid) = v;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int t = t0 + V * tid + j;
      if (t < tend) {
        const float v = xr[t];
        keys[OFF + t - t0] = sort_key(v);
        vals[OFF + t - t0] = v;
      }
    }
  }
  // the halos: P positions before t0 and P after tend, reflected
  if (tid < 2 * P) {
    const int t = tid < P ? t0 - P + tid : tend + tid - P;
    const float v = xr[reflect(t, T)];
    keys[OFF + t - t0] = sort_key(v);
    vals[OFF + t - t0] = v;
  }
  __syncthreads();

  int k[NK];
#pragma unroll
  for (int j = 0; j < NK; j += 4) {
    const int4 v = *reinterpret_cast<const int4*>(keys + V * tid + j);
    k[j] = v.x; k[j + 1] = v.y; k[j + 2] = v.z; k[j + 3] = v.w;
  }
  // k[j] is the key of row position t0 + V tid - OFF + j: output t + u's
  // window is k[OFF - P + u .. OFF + P + u]
  const int t = t0 + V * tid;
  const int* win = k + OFF - P;
  float o[V];
#pragma unroll
  for (int u = 0; u < V; u += 2) {
    int med0 = win[u], med1 = win[u + 1];
    if constexpr (W > 1) {
      int s[2 * P];  // the pair's shared values win[u + 1 .. u + W)
#pragma unroll
      for (int j = 0; j < 2 * P; ++j) s[j] = win[u + 1 + j];
      sort_net<2 * P>(s);
      med0 = max(s[P - 1], min(win[u], s[P]));
      med1 = max(s[P - 1], min(win[u + W], s[P]));
    }
    // (past the tile's end the keys are not loaded and nothing is stored)
    const float* wv = vals + V * tid + OFF - P + u;  // output t + u's window values
    o[u] = t + u < tend ? median_value<W>(win + u, med0, wv) : 0.f;
    o[u + 1] = t + u + 1 < tend ? median_value<W>(win + u + 1, med1, wv + 1) : 0.f;
  }
  if ((reinterpret_cast<uintptr_t>(outr + t0) & 15) == 0 && t + V <= tend) {
    *reinterpret_cast<float4*>(outr + t) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (t + j < tend) outr[t + j] = o[j];
  }
}

template <int W>
void launch(const float* x, float* out, long long rows, int T, cudaStream_t stream) {
  const int tiles = (T + TILE - 1) / TILE;
  median_kernel<W><<<(unsigned)(rows * tiles), THREADS, 0, stream>>>(x, out, T, tiles);
}

}  // namespace

// x, out: (rows, T) f32, contiguous
extern "C" int median_filter(const void* x, void* out, long long rows, int T, int width,
                             void* stream) {
  if (rows <= 0 || T <= width / 2 || rows * ((T + TILE - 1) / TILE) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: launch<1>(xp, op, rows, T, s); break;
    case 3: launch<3>(xp, op, rows, T, s); break;
    case 5: launch<5>(xp, op, rows, T, s); break;
    case 7: launch<7>(xp, op, rows, T, s); break;
    case 9: launch<9>(xp, op, rows, T, s); break;
    case 11: launch<11>(xp, op, rows, T, s); break;
    case 13: launch<13>(xp, op, rows, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
