// E1: matmul with a bias and residual epilogue, out = res + (round(x @ w)
// + bias), for x (M, K), w (K, N), bias (N,), res and out (M, N).
//
// Replaces scripts/_matmul_pallas_experiment.py:matmul_residual_pallas
// (body _mm_res_kernel): f32 accumulation over all of K, one rounding to
// the output (res's) dtype, then the bias and the residual added in that
// dtype, each sum rounded: (y + bias) + res, as the TPU kernel's epilogue
// and models.whisper._linear plus the residual add.  Built for the
// encoder's fc2 (large-v3 at batch 16: M = 24000, K = 5120, N = 1280).
//
// What bounds it on an H100: 2 M K N operations against (M K + K N + 2 M N)
// elements, 3.15e11 flops and 382 MB in bf16 at the fc2 shape, about 820
// flops per byte, far above the 295 where the tensor cores rather than
// the memory become the limit: it is bound by arithmetic (0.318 ms at
// 989 TFLOP/s against 0.114 ms for the bytes).
//
// Design: the TPU kernel walks K as a sequential grid axis with the f32
// accumulator in VMEM and the epilogue on the last K step.  Blocks on a GPU
// run in no order, so here one block owns a 128 x 128 output tile and loops
// over K itself, its f32 accumulators in registers, and applies the
// epilogue once at the end.  bf16: mma.sync m16n8k16 on the tensor cores;
// 8 warps of 64 x 32 outputs each; x and w tiles of 32 deep staged in shared
// memory by cp.async, three stages in flight; A fragments by ldmatrix, B
// fragments by ldmatrix.trans from w's (K, N) row-major tile.  The last row
// tile is masked (rows past M load zeros and store nothing).  f32: the
// same tiles on the CUDA cores in f32 (64 x 64 per block, 4 x 4 outputs
// per thread).  Shape predicate (fits): K a multiple of 32 (the K tile), N
// a multiple of 8 (16-byte rows).  wgmma, TMA and a producer warp are later
// work.

#include <cmath>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 128, BKT = 32, STAGES = 3, THREADS = 256;
constexpr int LDA = BKT + 8;  // x tile row stride (elements): conflict-free ldmatrix
constexpr int LDB = BN + 8;   // w tile row stride
constexpr int STAGE_ELEMS = BM * LDA + BKT * LDB;
constexpr size_t TC_SMEM = (size_t)STAGES * STAGE_ELEMS * sizeof(bf16);

// the epilogue of one output: round(acc) to T, + bias, + res, each rounded
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, const T* res, size_t r, int c, int N) {
  float y = round_to<T>(acc);
  y = round_to<T>(y + to_f(bias[c]));
  return from_f<T>(y + to_f(res[r * N + c]));
}

__global__ void __launch_bounds__(THREADS)
matmul_residual_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, const bf16* __restrict__ res,
                          bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int bm0 = blockIdx.y * BM, bn0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // this warp's 64 x 32 outputs

  auto load_stage = [&](int stage, int k0) {
    bf16* As = smem + stage * STAGE_ELEMS;
    bf16* Bs = As + BM * LDA;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // x: 128 rows x 4 vectors of 8
      const int c = tid + i * THREADS, r = c >> 2, col = (c & 3) * 8;
      const bool valid = bm0 + r < M;
      cp_async16(As + r * LDA + col, x + (size_t)(valid ? bm0 + r : 0) * K + k0 + col, valid);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // w: 32 rows x 16 vectors of 8
      const int c = tid + i * THREADS, r = c >> 4, col = (c & 15) * 8;
      const bool valid = bn0 + col < N;
      cp_async16(Bs + r * LDB + col, w + (size_t)(k0 + r) * N + (valid ? bn0 + col : 0), valid);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = K / BKT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BKT);
    cp_async_commit();  // one group per stage, empty or not, so the waits count alike
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BKT);
    cp_async_commit();
    const bf16* As = smem + (kt % STAGES) * STAGE_ELEMS;
    const bf16* Bs = As + BM * LDA;
#pragma unroll
    for (int kk = 0; kk < BKT; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], As + (wm + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn + nj * 16 +
                                 (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16_m16n8k16(acc[mi][nj], a[mi], b[nj]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = bm0 + wm + mi * 16 + g + 8 * half;
      if (r >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int c = bn0 + wn + nj * 8 + 2 * tig;
        if (c >= N) continue;
        const bf16 lo = epilogue<bf16>(acc[mi][nj][2 * half], bias, res, r, c, N);
        const bf16 hi = epilogue<bf16>(acc[mi][nj][2 * half + 1], bias, res, r, c + 1, N);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) = __halves2bfloat162(lo, hi);
      }
    }
  }
}

// f32 on the CUDA cores: a 64 x 64 output tile per block of 256 threads,
// thread (tx, ty) owning rows {ty + 16 i} x columns {tx + 16 j}, i, j < 4;
// 16-deep tiles of x (stored k-major) and w in shared memory
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
matmul_residual_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ res,
                           float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[FK][FM + 4], Ws[FK][FN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm0 = blockIdx.y * FM, bn0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    {  // x: 64 rows x 4 float4, transposed into As
      const int r = tid >> 2, kq = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bm0 + r < M) v = *reinterpret_cast<const float4*>(x + (size_t)(bm0 + r) * K + k0 + kq);
      As[kq][r] = v.x;
      As[kq + 1][r] = v.y;
      As[kq + 2][r] = v.z;
      As[kq + 3][r] = v.w;
    }
    {  // w: 16 rows x 16 float4
      const int r = tid >> 4, c = (tid & 15) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (bn0 + c < N) v = *reinterpret_cast<const float4*>(w + (size_t)(k0 + r) * N + bn0 + c);
      *reinterpret_cast<float4*>(&Ws[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = bm0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = bn0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = epilogue<float>(acc[i][j], bias, res, r, c, N);
    }
  }
}

}  // namespace

// out (M, N) = res + (round(x (M, K) @ w (K, N)) + bias (N,)), all of one
// dtype (bf16 or f32), row-major and contiguous; K a multiple of 32, N of 8
extern "C" int matmul_residual(int dtype, const void* x, const void* w, const void* bias,
                               const void* res, void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < BKT || K % BKT != 0 || N < 8 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) {
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    const cudaError_t attr = cudaFuncSetAttribute(
        matmul_residual_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TC_SMEM);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    matmul_residual_tc_kernel<<<grid, THREADS, TC_SMEM, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(res), static_cast<bf16*>(out), M, K, N);
  } else if (dtype == DTYPE_F32) {
    if ((M + FM - 1) / FM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    matmul_residual_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<const float*>(res), static_cast<float*>(out), M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
