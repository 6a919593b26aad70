// E2: the logits x . emb^T streamed over the vocabulary, f32 out, for x
// (B, C) bf16 and the embedding (V, C) ("vc") or a (C, V) copy of it
// ("cv"), bf16.
//
// Replaces scripts/_logits_experiment.py:main's Pallas variants D
// (make_pallas_vc, the (V, C) embedding in V chunks) and E
// (make_pallas_cv, the (C, V) copy): dot_general with f32 accumulation and
// an f32 output, unrounded.
//
// What bounds it on an H100: at B = 16 rows of turbo's vocabulary (V =
// 51866, C = 1280) the weight is 133 MB against 2 B V C = 2.1e9
// operations, 16 per byte: bound by device memory (0.040 ms at 3.35 TB/s).
// So each weight element is read once, with 16-byte loads (4-byte ones in
// the (C, V) copy of a V that is not a multiple of 8), for all rows at
// once, and the products run on the tensor cores (mma.sync m16n8k16, the
// x rows as A, zero-padded to 16): on the CUDA cores 16 rows cost 16 FMAs
// and as many shared-memory reads per weight, more than the bytes' time.
//
// Design: the TPU walks V in chunks of 512-4096 (its VMEM and (8, 128)
// tiling; V padded to 51968).  Here V is any size, and the grid is sized
// to fill the 132 SMs: 13 chunks of 4096 would leave most of them idle.
// vc: a block of 8 warps takes 128 vocabulary rows, each warp 16 (two n
// tiles), and walks all of C itself: its lanes load their rows' weights
// straight from device memory into B fragments (8 consecutive weights a
// lane, the K order inside each 32-wide slab permuted alike on the x side,
// as K2's tensor-core GEMV does, csrc/fused_step.cu gemv_tc_kernel), no
// shared memory for weights and no reduction across warps.  cv: a
// vocabulary row's weights are a column of the copy, so a block of 4 warps
// takes 64 columns and stages 32-row slabs of them in shared memory by
// cp.async, four in flight, and reads B fragments by ldmatrix.trans.  Both
// keep the block's 16 x rows in shared memory; more than 16 rows take
// further row tiles (grid.y), each reading the weights again (from L2 where
// they stay).  Rows past V read the last row and store nothing.

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE_ROWS = 16;   // x rows per block (the mma's M)
constexpr int SLAB = 32;        // K per step: two mma k16 steps
constexpr int VC_WARPS = 8, VC_NT = 2;  // vc: 8 warps x 2 n tiles of 8 rows
constexpr int VC_ROWS = VC_WARPS * VC_NT * 8;
constexpr int CV_WARPS = 4, CV_BN = 64, CV_STAGES = 4;  // cv: 64 columns per block
constexpr int CV_LDB = CV_BN + 8;

// x rows [b0, b0 + 16) of (B, C) into xs (16, ldx), zeros past B
__device__ __forceinline__ void load_x_tile(bf16* xs, int ldx, const bf16* __restrict__ x, int b0,
                                            int B, int C) {
  const int vecs = C / 8;
  for (int e = threadIdx.x; e < TILE_ROWS * vecs; e += blockDim.x) {
    const int r = e / vecs, c = (e - r * vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + r < B) v = *reinterpret_cast<const uint4*>(x + (size_t)(b0 + r) * C + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
}

// the C fragment of rows b0 + g (+ 8), vocabulary columns v, v + 1
__device__ __forceinline__ void store_c(float* __restrict__ out, const float* acc, int b0, int g,
                                        int v, int B, int V) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = b0 + g + 8 * half;
    if (b >= B) continue;
    if (v < V) out[(size_t)b * V + v] = acc[2 * half];
    if (v + 1 < V) out[(size_t)b * V + v + 1] = acc[2 * half + 1];
  }
}

// (V, C): x rows padded by 32 elements (16 words), so the 16-byte loads
// of 8 rows x 4 lanes fall in distinct banks
__global__ void __launch_bounds__(VC_WARPS * 32)
logits_vc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ emb, float* __restrict__ out,
                 int B, int C, int V) {
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);
  const int ldx = C + 32;
  const int b0 = blockIdx.y * TILE_ROWS;
  load_x_tile(xs, ldx, x, b0, B, C);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int v0 = blockIdx.x * VC_ROWS + warp * VC_NT * 8;
  if (v0 >= V) return;
  const bf16* w[VC_NT];
#pragma unroll
  for (int j = 0; j < VC_NT; ++j) w[j] = emb + (size_t)min(v0 + 8 * j + g, V - 1) * C + tig * 8;
  const bf16* h_lo = xs + g * ldx + tig * 8;
  const bf16* h_hi = h_lo + 8 * ldx;
  float acc[VC_NT][4] = {};
#pragma unroll 4
  for (int k = 0; k < C; k += SLAB) {
    uint4 wv[VC_NT];
#pragma unroll
    for (int j = 0; j < VC_NT; ++j) wv[j] = __ldcs(reinterpret_cast<const uint4*>(w[j] + k));
    const uint4 lo = *reinterpret_cast<const uint4*>(h_lo + k);
    const uint4 hi = *reinterpret_cast<const uint4*>(h_hi + k);
    const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
    for (int j = 0; j < VC_NT; ++j) {
      const uint32_t p0[2] = {wv[j].x, wv[j].y}, p1[2] = {wv[j].z, wv[j].w};
      mma_bf16_m16n8k16(acc[j], a0, p0);
      mma_bf16_m16n8k16(acc[j], a1, p1);
    }
  }
#pragma unroll
  for (int j = 0; j < VC_NT; ++j) store_c(out, acc[j], b0, g, v0 + 8 * j + 2 * tig, B, V);
}

// (C, V): VEC elements per copy, 8 (16 bytes) where V is a multiple of 8,
// 2 (4 bytes) where it is even, else 1 (plain loads)
template <int VEC>
__device__ __forceinline__ void load_cv_stage(bf16* bs, const bf16* __restrict__ emb_t, int c0,
                                              int n0, int V) {
  constexpr int PER_ROW = CV_BN / VEC;
  for (int e = threadIdx.x; e < SLAB * PER_ROW; e += blockDim.x) {
    const int r = e / PER_ROW, col = (e - r * PER_ROW) * VEC;
    const bool valid = n0 + col < V;
    const bf16* src = emb_t + (size_t)(c0 + r) * V + (valid ? n0 + col : 0);
    bf16* dst = bs + r * CV_LDB + col;
    if constexpr (VEC == 8) {
      cp_async16(dst, src, valid);
    } else if constexpr (VEC == 2) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                   "r"(valid ? 4 : 0));
    } else {
      *dst = valid ? *src : __float2bfloat16_rn(0.f);
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(CV_WARPS * 32)
logits_cv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ emb_t,
                 float* __restrict__ out, int B, int C, int V) {
  extern __shared__ float4 smem4[];
  const int ldx = C + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem4);
  bf16* stages = xs + TILE_ROWS * ldx;  // CV_STAGES x (SLAB, CV_LDB)
  const int b0 = blockIdx.y * TILE_ROWS, n0 = blockIdx.x * CV_BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nk = C / SLAB;
#pragma unroll
  for (int s = 0; s < CV_STAGES - 1; ++s) {
    if (s < nk) load_cv_stage<VEC>(stages + s * SLAB * CV_LDB, emb_t, s * SLAB, n0, V);
    cp_async_commit();
  }
  load_x_tile(xs, ldx, x, b0, B, C);
  float acc[2][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<CV_STAGES - 2>();
    __syncthreads();  // slab kt is in (and the x tile); slab kt - 1 is consumed
    if (kt + CV_STAGES - 1 < nk)
      load_cv_stage<VEC>(stages + ((kt + CV_STAGES - 1) % CV_STAGES) * SLAB * CV_LDB, emb_t,
                         (kt + CV_STAGES - 1) * SLAB, n0, V);
    cp_async_commit();
    const bf16* bs = stages + (kt % CV_STAGES) * SLAB * CV_LDB;
#pragma unroll
    for (int kk = 0; kk < SLAB; kk += 16) {
      uint32_t a[4], r[4];
      ldmatrix_x4(a, xs + (lane & 15) * ldx + kt * SLAB + kk + (lane >> 4) * 8);
      ldmatrix_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * CV_LDB + warp * 16 +
                               (lane >> 4) * 8);
      const uint32_t b_lo[2] = {r[0], r[1]}, b_hi[2] = {r[2], r[3]};
      mma_bf16_m16n8k16(acc[0], a, b_lo);
      mma_bf16_m16n8k16(acc[1], a, b_hi);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j) store_c(out, acc[j], b0, g, n0 + warp * 16 + 8 * j + 2 * tig, B, V);
}

template <typename K>
int with_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// out (B, V) f32 = x (B, C) . emb^T, emb (V, C) (layout 0, "vc") or its
// (C, V) copy (layout 1, "cv"); bf16, contiguous; C a multiple of 32
extern "C" int logits_streamed(int layout, int B, int C, int V, const void* x, const void* emb,
                               void* out, void* stream) {
  if (B < 1 || C < SLAB || C % SLAB != 0 || V < 1 || (B + TILE_ROWS - 1) / TILE_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(emb);
  float* o = static_cast<float*>(out);
  const int tiles = (B + TILE_ROWS - 1) / TILE_ROWS;
  if (layout == 0) {
    const size_t smem = (size_t)TILE_ROWS * (C + 32) * sizeof(bf16);
    if (int e = with_smem(logits_vc_kernel, smem)) return e;
    logits_vc_kernel<<<dim3((V + VC_ROWS - 1) / VC_ROWS, tiles), VC_WARPS * 32, smem, s>>>(
        xb, w, o, B, C, V);
  } else if (layout == 1) {
    const size_t smem = ((size_t)TILE_ROWS * (C + 8) + (size_t)CV_STAGES * SLAB * CV_LDB) * sizeof(bf16);
    const dim3 grid((V + CV_BN - 1) / CV_BN, tiles);
#define CV(VEC)                                                                  \
  do {                                                                           \
    if (int e = with_smem(logits_cv_kernel<VEC>, smem)) return e;                \
    logits_cv_kernel<VEC><<<grid, CV_WARPS * 32, smem, s>>>(xb, w, o, B, C, V);  \
  } while (0)
    if (V % 8 == 0) CV(8);
    else if (V % 2 == 0) CV(2);
    else CV(1);
#undef CV
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
