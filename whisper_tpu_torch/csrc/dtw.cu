// K4: the DTW trace by a wavefront of warps, one trace slot per lane.
//
// Replaces whisper_tpu/ops/kernels/dtw_pallas.py:dtw_trace_pallas (body
// _dtw_kernel).  Same contract: x (B, n, m) f32 costs; the output is
// (B, n + m + 1, n + 1) int32 diagonals, trace[b, d, i] holding the choice
// made at cell (i, j = d - i) of the (n + 1) x (m + 1) cost matrix: 0 the
// diagonal, 1 up, 2 left, ties to 2; each cell adds its cost x[i-1, j-1]
// to the cost of the branch it chose (not to the minimum), in f32, and
// cells outside the matrix hold +inf.  Diagonals 0 and 1 are zeros.  The
// choice is computed at every slot, inside the matrix or not, so the trace
// is bit-equal to ops/dtw._dtw_trace_device's.
//
// What bounds it on an H100: the chain of n + m - 1 dependent diagonals
// (1752 at the word-timing shape n = 253, m = 1500), each a cell update
// (two compares, selects and an add, 17.5 cycles in a chain: dtw_chain
// below) after its upper neighbour's; neither the bytes (1.5 MB in, 1.8 MB
// out) nor the operations bound it.  Here a diagonal also waits on a
// shuffle (about 36 cycles), and on the instructions every warp issues a
// step (a shuffle, a global store and a staging copy, memory instructions
// all), which pace the steps (PERF.md section 6).
//
// Design: the TPU kernel skews x into diagonal layout and walks the
// diagonals with whole-vector ops, a diagonal a step.  Here a block takes
// one matrix, warp w the slots i = 32 w + lane.  The lanes of a warp walk
// the diagonals together, one a step: a lane keeps its slot's last cost in
// a register and takes its upper neighbour's from the lane before by
// __shfl_up_sync, so inside a warp no barrier orders the diagonals.  Warp w
// runs K diagonals behind warp w - 1 (K = 32; 16 above 16 warps, for
// shared memory) and takes the cost of slot 32 w - 1 from a ring in shared
// memory that warp w - 1's last lane writes; one block barrier every K
// diagonals makes a chunk's ring entries visible (the lag means a chunk
// only reads entries of earlier chunks), in place of a barrier per
// diagonal.  x is staged a chunk ahead: each warp copies its 32 rows' next
// K costs (a contiguous run of a row, K lanes a row) into shared memory by
// 4-byte cp.async while it computes the chunk before, so no diagonal waits
// on device memory; a lane reads four diagonals' costs of its row at a time
// (16-byte loads, rows K + 4 apart, free of bank conflicts), and the
// ring's costs four diagonals a 16-byte load and store.  A warp's step
// writes one diagonal's 32 consecutive slots: one coalesced 128-byte store,
// predicated, with no branch in the step (the ring above warp 0 holds
// +inf).

#include <cmath>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MAX_WARPS = 32;  // n + 1 <= 1024 slots

// One cell: the choice among cost[i-1, j-1] (c0), cost[i-1, j] (c1) and
// cost[i, j-1] (c2), ties to 2, and the cell's cost (+inf outside the
// matrix).  The same comparisons and add as ops/dtw._dtw_trace_device.
__device__ __forceinline__ float dtw_cell(float c0, float c1, float c2, float xv, bool valid, int& t) {
  const bool p0 = c0 < c1 && c0 < c2;
  const bool p1 = c1 < c0 && c1 < c2;
  t = p0 ? 0 : (p1 ? 1 : 2);
  const float c = p0 ? c0 : (p1 ? c1 : c2);
  return valid ? xv + c : INFINITY;
}

// 4 bytes from global to shared memory, asynchronously; zero where !valid
// (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// K: diagonals per chunk, a warp's lag behind the one before (32 up to 16
// warps, 16 above, for shared memory)
template <int K>
__global__ void __launch_bounds__(1024)
dtw_trace_kernel(const float* __restrict__ x, int* __restrict__ trace, int n, int m) {
  constexpr int XS = K + 4;      // row stride of a staged chunk of costs (16-byte rows)
  constexpr int RING = 4 * K;    // hand-off ring, >= 2 K + 1 diagonals, a power of two
  extern __shared__ __align__(16) float smem[];
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // [2][W][32][XS]: staged costs; ring [W + 1][RING]: ring w + 1 holds slot
  // 32 w + 31's cost on diagonal d at (d - 2) % RING, ring 0 the +inf of the
  // slots above slot 0
  float* xs = smem;
  float* ring = smem + 2 * W * 32 * XS;
  const int n1 = n + 1;
  const float* xb = x + (size_t)blockIdx.x * n * m;
  int* tb = trace + (size_t)blockIdx.x * (n + m + 1) * n1;

  for (int e = threadIdx.x; e < 2 * n1; e += blockDim.x) tb[e] = 0;  // diagonals 0 and 1
  for (int e = threadIdx.x; e < (W + 1) * RING; e += blockDim.x) ring[e] = INFINITY;

  // the lane's slot and its state before diagonal 2: its own cost on
  // diagonal 1 (inf) and slot i - 1's on diagonal 0 (cost[0, 0] = 0 at i = 1)
  const int i = 32 * w + lane;
  float own = INFINITY, up_before = i == 1 ? 0.f : INFINITY;
  const bool store = i <= n;
  const unsigned m_eff = i >= 1 && i <= n ? m : 0;  // valid at d iff d - i - 1 < m_eff
  const int steps = n + m - 1 + (W - 1) * K, chunks = (steps + K - 1) / K;

  // staging: chunk c of warp w is diagonals [d0, d0 + K), d0 = 2 + (c - w)
  // K; row r's costs x[i - 1, d0 - i - 1 + k] (i = 32 w + r) go to
  // xs[r][k].  Lane copies element k = lane % K of rows r = lane / K + (32
  // / K) q, q < K: from one q to the next its row 32 / K down and its
  // column as many back
  const int kc = lane & (K - 1), r0 = lane / K;
  auto stage = [&](int c) {
    const int d0 = 2 + (c - w) * K;
    if (d0 + K <= 2 || d0 > n + m) return;  // no diagonal of the chunk is real
    float* dst = xs + ((c & 1) * W + w) * 32 * XS + r0 * XS + kc;
    int ii = 32 * w + r0, col = d0 + kc - ii - 1;
    const float* src = xb + (ptrdiff_t)(ii - 1) * m + col;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const bool ok = (unsigned)(ii - 1) < (unsigned)n && (unsigned)col < (unsigned)m;
      cp_async4(dst, ok ? src : xb, ok);
      dst += (32 / K) * XS;
      ii += 32 / K;
      col -= 32 / K;
      src += (ptrdiff_t)(32 / K) * (m - 1);
    }
  };
  stage(0);
  cp_async_commit();

  const float* ring_in = ring + w * RING;
  float* ring_out = ring + (w + 1) * RING;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    // chunk c's costs have landed; every ring entry of chunk c - 1 is
    // written; nobody reads chunk c - 1's buffer any more
    __syncthreads();
    if (c + 1 < chunks) stage(c + 1);
    cp_async_commit();
    const int d0 = 2 + (c - w) * K;
    const int kb = max(0, 2 - d0), ke = min(K, n + m + 1 - d0);  // real diagonals [kb, ke)
    if (kb >= ke) continue;  // warp-uniform
    const float* xr = xs + (((c & 1) * W + w) * 32 + lane) * XS;
    int* tp = tb + (size_t)d0 * n1 + i;  // slot i of diagonal d0
    // diagonal d0 + k of this warp's ring at ring_out[base + k], of the warp
    // before at ring_in[base + k] (base a multiple of K, K | RING)
    const int base = (d0 - 2) & (RING - 1);
    // one diagonal: the upper neighbour's cost on diagonal d - 1 from the
    // lane before (lane 0: `up0`, from the warp before through its ring),
    // the cell and its code; returns the cell's cost
    auto step = [&](int k, float xv, float up0) {
      const int d = d0 + k;
      float up = __shfl_up_sync(0xffffffffu, own, 1);
      up = lane == 0 ? up0 : up;
      int t;
      const float v = dtw_cell(up_before, up, own, xv, (unsigned)(d - i - 1) < m_eff, t);
      if (store) tp[(size_t)k * n1] = t;
      up_before = up;
      own = v;
      return v;
    };
    if (kb == 0 && ke == K) {
      // four diagonals a group: their costs and upper costs a 16-byte load
      // each (the upper cost of diagonal d0 + k is the ring's entry k - 1),
      // the last lane's four costs into the ring a 16-byte store
      float up0 = ring_in[(d0 - 3) & (RING - 1)];
#pragma unroll
      for (int k4 = 0; k4 < K; k4 += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + k4);
        const float4 a = *reinterpret_cast<const float4*>(ring_in + base + k4);
        float4 v;
        v.x = step(k4, xv.x, up0);
        v.y = step(k4 + 1, xv.y, a.x);
        v.z = step(k4 + 2, xv.z, a.y);
        v.w = step(k4 + 3, xv.w, a.z);
        if (lane == 31) *reinterpret_cast<float4*>(ring_out + base + k4) = v;
        up0 = a.w;
      }
    } else {
      for (int k = kb; k < ke; ++k) {
        const float v = step(k, xr[k], ring_in[(d0 + k - 3) & (RING - 1)]);
        if (lane == 31) ring_out[base + k] = v;
      }
    }
  }
}

// The per-update latency of the chain that bounds the kernel: one thread
// runs `iters` cell updates, each taking the one before's cost as its c1
// (the upper neighbour, as on the wavefront's critical path).
__global__ void dtw_chain_kernel(const float* __restrict__ seed, float* out, int* codes, int iters) {
  float c0 = seed[0], c1 = seed[1];
  const float c2 = seed[2], xv = seed[3];
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
    int t;
    const float v = dtw_cell(c0, c1, c2, xv, true, t);
    acc += t;
    c0 = c1;
    c1 = v;
  }
  out[0] = c1;
  codes[0] = acc;
}

template <int K>
int launch(const float* x, int* trace, int batch, int n, int m, cudaStream_t stream) {
  const int warps = (n + 1 + 31) / 32;
  const size_t smem = ((size_t)2 * warps * 32 * (K + 4) + (size_t)(warps + 1) * 4 * K) * sizeof(float);
  const cudaError_t e = allow_smem((const void*)dtw_trace_kernel<K>, smem);
  if (e != cudaSuccess) return (int)e;
  dtw_trace_kernel<K><<<batch, 32 * warps, smem, stream>>>(x, trace, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, n, m) f32 contiguous; trace: (B, n + m + 1, n + 1) int32
extern "C" int dtw_trace(const void* x, void* trace, int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || n + 1 > 32 * MAX_WARPS || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  int* tp = static_cast<int*>(trace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n + 1 <= 16 * 32 ? launch<32>(xp, tp, batch, n, m, s) : launch<16>(xp, tp, batch, n, m, s);
}

// seed: 4 f32 (c0, c1, c2, x); out: 1 f32; codes: 1 int32
extern "C" int dtw_chain(const void* seed, void* out, void* codes, int iters, void* stream) {
  if (iters <= 0) return (int)cudaErrorInvalidValue;
  dtw_chain_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seed), static_cast<float*>(out), static_cast<int*>(codes), iters);
  return (int)cudaGetLastError();
}
