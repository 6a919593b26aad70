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
// accumulator in VMEM and the epilogue on the last K step.  Here (bf16)
// a persistent grid, one block per SM, walks the 128 x 256 output tiles
// (the five column tiles of one row tile in turn, so the blocks in flight
// share their x rows in L2) and each block loops over K itself.  A
// producer warpgroup (one thread) keeps a ring of four stages full by TMA:
// x's (128 rows, 64 K) box, K-major, and w's (64 K, 256 N) as four
// 64-column boxes, MN-major, both in the 128-byte swizzle (hopper.cuh).
// Two consumer warpgroups own 64 rows each and run wgmma m64n256k16 with
// 128 f32 accumulators a thread, one K step's four wgmmas kept in flight
// while the previous step's stage is released.  The epilogue reads the
// accumulators in registers, so one tile's epilogue overlaps the next
// tile's loads.  Rows past M and columns past N arrive as zeros from TMA
// and are not stored.
// f32: the same tiles on the CUDA cores in f32 (64 x 64 per block, 4 x 4
// outputs per thread).  Shape predicate (fits): K a multiple of 32, N a
// multiple of 8 (16-byte rows, which TMA's strides need).  bf16 pointers
// must be 16-byte aligned (TMA).

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// the bf16 kernel: 128 x 256 output tiles, K in steps of 64, a ring of
// four stages (x 16 KB + w 32 KB each); two consumer warpgroups of 64 rows
// and a producer warpgroup
constexpr int BM = 128, BN = 256, BKT = 64, STAGES = 4, THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr uint32_t A_BYTES = BM * BKT * 2, B_BYTES = BKT * BN * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t TC_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 16 * STAGES;
constexpr int K_MULTIPLE = 32;  // the entry point's contract (the f32 kernel's K tile is 16)

// the epilogue of one output: round(acc) to T, + bias, + res, each rounded
template <typename T>
__device__ __forceinline__ T epilogue(float acc, const T* bias, const T* res, size_t r, int c, int N) {
  float y = round_to<T>(acc);
  y = round_to<T>(y + to_f(bias[c]));
  return from_f<T>(y + to_f(res[r * N + c]));
}

__global__ void __launch_bounds__(THREADS, 1)
matmul_residual_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                             const bf16* __restrict__ bias, const bf16* __restrict__ res,
                             bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x / 128;
  const int tiles_n = (N + BN - 1) / BN, tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + BKT - 1) / BKT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread walks this block's tiles
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + s, STAGE_BYTES);
          uint8_t* a = ring + s * STAGE_BYTES;
          hopper::tma_load_2d(a, &tx, full + s, kt * BKT, m0);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            hopper::tma_load_2d(a + A_BYTES + b * (BKT * 128), &tw, full + s, n0 + 64 * b, kt * BKT);
        }
      }
    }
  } else {  // consumer warpgroup wg: rows m0 + 64 wg ... + 63 of each tile
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(full + s, (it / STAGES) & 1);
        const uint8_t* a = ring + s * STAGE_BYTES;
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk) {
          // x: K-major, this warpgroup's 64 rows; w: MN-major (K rows of
          // N), four 64-column boxes 8 KB apart
          const uint64_t da = hopper::smem_desc(a + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = hopper::smem_desc(a + A_BYTES + kk * 2048, BKT * 128, 1024);
          hopper::wgmma_ss<1>(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        // keep this step's products in flight; the previous step's are done
        hopper::wgmma_wait<1>();
        hopper::fence_operands(acc);
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % STAGES);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % STAGES);

      // the epilogue, from the accumulators: d[4 j + 2 h + e] is row
      // 16 w + g + 8 h, column 8 j + 2 t + e; the producer meanwhile fills
      // the ring with the next tile's steps
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + 64 * wg + 16 * w + g + 8 * h;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = n0 + 8 * j + 2 * t;
          if (c >= N) continue;  // N is a multiple of 8: c + 1 < N too
          const bf16 lo = epilogue<bf16>(acc[4 * j + 2 * h], bias, res, r, c, N);
          const bf16 hi = epilogue<bf16>(acc[4 * j + 2 * h + 1], bias, res, r, c + 1, N);
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + c) = __halves2bfloat162(lo, hi);
        }
      }
    }
  }
}

int launch_wgmma(const bf16* x, const bf16* w, const bf16* bias, const bf16* res, bf16* out, int M, int K,
                 int N, cudaStream_t stream) {
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w),
                        static_cast<const void*>(bias), static_cast<const void*>(res),
                        static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int setup = hopper::prepare_launch(matmul_residual_wgmma_kernel, 2, CONSUMER_REGS, PRODUCER_REGS, TC_SMEM);
  if (setup != 0) return setup;
  // x (M, K) in boxes of 64 K x 128 rows; w (K, N) in boxes of 64 N x 64 K
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M}, xstrides[1] = {(uint64_t)K * 2};
  const uint64_t wdims[2] = {(uint64_t)N, (uint64_t)K}, wstrides[1] = {(uint64_t)N * 2};
  const uint32_t xbox[2] = {64, BM}, wbox[2] = {64, BKT};
  CUtensorMap tx, tw;
  if (hopper::make_tmap_bf16(&tx, x, 2, xdims, xstrides, xbox) != 0 ||
      hopper::make_tmap_bf16(&tw, w, 2, wdims, wstrides, wbox) != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
    return (int)cudaErrorInvalidDevice;
  const int blocks = tiles < sms ? tiles : sms;  // persistent: at most one block per SM
  matmul_residual_wgmma_kernel<<<blocks, THREADS, TC_SMEM, stream>>>(tx, tw, bias, res, out, M, K, N);
  return (int)cudaGetLastError();
}

// f32 on the CUDA cores: a 64 x 64 output tile per block of 256 threads,
// thread (tx, ty) owning rows {ty + 16 i} x columns {tx + 16 j}, i, j < 4;
// 16-deep tiles of x (stored k-major) and w in shared memory
constexpr int FM = 64, FN = 64, FK = 16, THREADS_F32 = 256;

__global__ void __launch_bounds__(THREADS_F32)
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
// dtype (bf16 or f32), row-major and contiguous; K a multiple of 32, N of 8;
// bf16 pointers 16-byte aligned (TMA)
extern "C" int matmul_residual(int dtype, const void* x, const void* w, const void* bias,
                               const void* res, void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < K_MULTIPLE || K % K_MULTIPLE != 0 || N < 8 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return launch_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
                        static_cast<const bf16*>(res), static_cast<bf16*>(out), M, K, N, s);
  if (dtype != DTYPE_F32) return (int)cudaErrorInvalidValue;
  if ((M + FM - 1) / FM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
  matmul_residual_f32_kernel<<<grid, THREADS_F32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
