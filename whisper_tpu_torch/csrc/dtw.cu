// K4: the DTW trace by an anti-diagonal wavefront.
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
// What bounds it on an H100: n + m - 1 diagonals in sequence (1754 at the
// word-timing shape n = 253, m = 1500), each a few instructions per thread
// and one block-wide barrier; the latency of that chain, not bytes or
// flops, bounds it.
//
// Design: the TPU kernel skews x into diagonal layout first and walks the
// diagonals with whole-vector ops, the two previous cost diagonals in VMEM.
// Here one block per batch row has one thread per i (n + 1 <= 1024); the
// two previous diagonals and the one being written rotate through three
// shared-memory buffers, so one __syncthreads() per diagonal orders them.
// x is read in place (x[i - 1, d - i - 1], scattered but L2-resident), and
// each thread loads its cost for the next diagonal before the barrier, so
// that load's latency overlaps the wait.

#include <cmath>

#include "common.cuh"

namespace {

__global__ void dtw_trace_kernel(const float* __restrict__ x, int* __restrict__ trace, int n,
                                 int m) {
  extern __shared__ float buf[];  // 3 diagonals of n + 1 costs
  const int n1 = n + 1;
  const int i = threadIdx.x;
  const bool mine = i < n1;
  const float* xb = x + (size_t)blockIdx.x * n * m;
  int* tb = trace + (size_t)blockIdx.x * (n + m + 1) * n1;
  float* prev2 = buf;        // diagonal d - 2
  float* prev = buf + n1;    // diagonal d - 1
  float* cur = buf + 2 * n1;  // diagonal d

  auto cost_at = [&](int d) {  // x[i - 1, d - i - 1], or 0 outside the matrix
    const int j = d - i;
    return (i >= 1 && j >= 1 && j <= m) ? xb[(size_t)(i - 1) * m + (j - 1)] : 0.f;
  };
  if (mine) {
    prev2[i] = i == 0 ? 0.f : INFINITY;  // d = 0: cost[0, 0] = 0
    prev[i] = INFINITY;                  // d = 1: cost[0, 1] = cost[1, 0] = inf
    tb[i] = 0;
    tb[n1 + i] = 0;
  }
  float x_next = mine ? cost_at(2) : 0.f;
  __syncthreads();

  for (int d = 2; d <= n + m; ++d) {
    if (mine) {
      const float xv = x_next;
      if (d < n + m) x_next = cost_at(d + 1);
      const float c0 = i > 0 ? prev2[i - 1] : INFINITY;  // cost[i-1, j-1]
      const float c1 = i > 0 ? prev[i - 1] : INFINITY;   // cost[i-1, j]
      const float c2 = prev[i];                          // cost[i, j-1]
      int t;
      float c;
      if (c0 < c1 && c0 < c2) {
        t = 0;
        c = c0;
      } else if (c1 < c0 && c1 < c2) {
        t = 1;
        c = c1;
      } else {
        t = 2;
        c = c2;
      }
      const int j = d - i;
      cur[i] = (i >= 1 && j >= 1 && j <= m) ? xv + c : INFINITY;
      tb[(size_t)d * n1 + i] = t;
    }
    __syncthreads();
    float* const spent = prev2;
    prev2 = prev;
    prev = cur;
    cur = spent;
  }
}

}  // namespace

// x: (B, n, m) f32 contiguous; trace: (B, n + m + 1, n + 1) int32
extern "C" int dtw_trace(const void* x, void* trace, int batch, int n, int m, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || n + 1 > 1024 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = (n + 1 + 31) / 32 * 32;
  const size_t smem = 3 * (size_t)(n + 1) * sizeof(float);
  dtw_trace_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int*>(trace), n, m);
  return (int)cudaGetLastError();
}
