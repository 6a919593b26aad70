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
// So each weight element is read once, for all rows at once, and the
// products run on the tensor cores (mma.sync m16n8k16): on the CUDA cores
// 16 rows cost 16 FMAs and as many shared-memory reads per weight, more
// than the bytes' time.
//
// Design: the TPU walks V in chunks of 512-4096 (its VMEM and (8, 128)
// tiling; V padded to 51968).  Here both layouts run a persistent grid,
// the SM count times the blocks an SM holds, and block i owns one
// contiguous range of the vocabulary, equal to within 16 rows (24 or 25
// tiles of 16 rows at V = 51866 on 132 blocks), so no SM runs a tail wave;
// each block stages its x rows (at most 64 a launch; more rows take
// further launches) in shared memory once and walks its range with the
// weights streaming through a ring of stages.
// vc: a producer warp keeps the ring full by TMA (boxes of 16 vocabulary
// rows x 64 C columns, 128-byte swizzle, hopper.cuh; the embedding's row
// stride, 2C bytes, is a multiple of 16 as TMA requires), one mbarrier
// pair per stage, VC_STAGES stages of 8 KB (four blocks an SM at one x
// row; of 4, 6, 8 and 12 stages, and of 24 on one block an SM, six were
// the fastest at one row on an H100).  Four consumer warps take one 16-row tile each of a
// stage's 64 rows: the vocabulary is the mma's M side, its A fragments
// read from the swizzled tile by ldmatrix, and x the N side, so up to 8
// rows pad to 8 (n8 tiles of x rows: 1, 2, 4 or 8), their B fragments read
// from the staged rows; all of a launch's rows are multiplied against the
// tile the block holds, so the weights leave device memory once per launch.
// The range's last stage loads only its valid 16-row boxes.
// cv: a vocabulary row's weights are a column of the copy, and at V =
// 51866 the copy's row stride (103,732 bytes) is no multiple of 16, so
// neither TMA (whose global strides must be multiples of 16 bytes) nor
// 16-byte copies can address its rows: four warps stage 32-row slabs of
// 64 columns by 4-byte cp.async (16-byte where V is a multiple of 8,
// plain loads where V is odd), CV_STAGES in flight, columns past the
// block's range zero-filled and never read, and read B fragments by
// ldmatrix.trans; x is the M side here (tiles of 16 rows, at most 4; the
// rows past the launch's read a row of zeros, so only its rows are staged).

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int SLAB = 32;       // C is a multiple of it
constexpr int MAX_XB = 64;     // x rows per launch
constexpr int SMEM_MAX = 232448;  // an H100 block's shared memory
// vc
constexpr int VC_CONSUMERS = 4;   // consumer warps, one 16-row tile of a stage each
constexpr int VC_THREADS = (VC_CONSUMERS + 1) * 32;
constexpr int VC_K = 64;          // C columns per stage: one 128-byte swizzle span
constexpr int VC_STAGES = 6;
constexpr int BOX_BYTES = 16 * VC_K * 2;               // one 16-row box
constexpr int STAGE_BYTES = VC_CONSUMERS * BOX_BYTES;  // 64 vocabulary rows
// cv
constexpr int CV_WARPS = 4, CV_BN = 64, CV_STAGES = 8;  // 64 columns per tile
constexpr int CV_LDB = CV_BN + 8;

// block i of n's share of `units`: [u0, u1), sizes equal to within one
__device__ __forceinline__ void balanced(int units, int& u0, int& u1) {
  const int q = units / (int)gridDim.x, rem = units % (int)gridDim.x, i = (int)blockIdx.x;
  u0 = i * q + min(i, rem);
  u1 = u0 + q + (i < rem ? 1 : 0);
}

// x rows [0, xb) of (xb, C) into xs (rows, ldx), zeros past C and past xb
__device__ __forceinline__ void stage_x(bf16* xs, int ldx, int rows, const bf16* __restrict__ x, int xb,
                                        int C) {
  const int vecs = ldx / 8;
  for (int e = threadIdx.x; e < rows * vecs; e += blockDim.x) {
    const int r = e / vecs, c = (e - r * vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < xb && c < C) v = *reinterpret_cast<const uint4*>(x + (size_t)r * C + c);
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
}

template <int NT>
__global__ void __launch_bounds__(VC_THREADS)
logits_vc_kernel(const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x, float* __restrict__ out,
                 int xb, int C, int V, int kpad) {
  constexpr int stages = VC_STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the ring 1024-byte aligned (the swizzle's period), then x, then the barriers
  unsigned char* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int ldx = kpad + 8;  // 16 bytes of padding: the B fragments' rows on distinct banks
  bf16* xs = reinterpret_cast<bf16*>(ring + stages * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + (size_t)xb * ldx);
  uint64_t* empty = full + stages;

  int m0, m1;  // this block's 16-row tiles
  balanced((V + 15) / 16, m0, m1);
  const int nks = kpad / VC_K;
  const int total = (m1 - m0 + VC_CONSUMERS - 1) / VC_CONSUMERS * nks;  // stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], VC_CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  stage_x(xs, ldx, xb, x, xb, C);
  __syncthreads();

  if (warp == VC_CONSUMERS) {  // the producer
    if (lane == 0) {
      for (int u = 0; u < total; ++u) {
        const int s = u % stages, vt = u / nks, ks = u - vt * nks;
        hopper::mbar_wait(&empty[s], ((u / stages) & 1) ^ 1);
        const int mt = m0 + vt * VC_CONSUMERS, boxes = min(VC_CONSUMERS, m1 - mt);
        hopper::mbar_arrive_expect_tx(&full[s], boxes * BOX_BYTES);
        for (int b = 0; b < boxes; ++b)
          hopper::tma_load_2d(ring + s * STAGE_BYTES + b * BOX_BYTES, &tw, &full[s], ks * VC_K, (mt + b) * 16);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int u = 0; u < total; ++u) {
    const int s = u % stages, vt = u / nks, ks = u - vt * nks;
    const int mt = m0 + vt * VC_CONSUMERS + warp;
    hopper::mbar_wait(&full[s], (u / stages) & 1);
    if (mt < m1) {
      const unsigned char* box = ring + s * STAGE_BYTES + warp * BOX_BYTES;
#pragma unroll
      for (int kk = 0; kk < VC_K; kk += 16) {
        // A: row lane % 16 of the box, 16-byte chunk kk / 8 + lane / 16,
        // where the 128-byte swizzle put it (chunk ^ row % 8)
        const int r = lane & 15, c = kk / 8 + (lane >> 4);
        uint32_t a[4];
        ldmatrix_x4(a, box + r * 128 + ((c ^ (r & 7)) << 4));
        const int k = ks * VC_K + kk + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = 8 * j + g;  // x row
          uint32_t b[2] = {0u, 0u};
          if (n < xb) {
            b[0] = *reinterpret_cast<const uint32_t*>(xs + n * ldx + k);
            b[1] = *reinterpret_cast<const uint32_t*>(xs + n * ldx + k + 8);
          }
          mma_bf16_m16n8k16(acc[j], a, b);
        }
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    if (ks == nks - 1) {  // the tile's last stage: its logits are done
      if (mt < m1) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int v = mt * 16 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
            if (v < V && n < xb) out[(size_t)n * V + v] = acc[j][e];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
  }
}

// one 32-row slab of the (C, V) copy, columns [n0, n0 + 64) of which those
// at or past `end` are zero-filled: VEC elements per copy, 8 (16 bytes)
// where V is a multiple of 8, 2 (4 bytes) where it is even, else 1 (plain
// loads)
template <int VEC>
__device__ __forceinline__ void load_cv_stage(bf16* bs, const bf16* __restrict__ emb_t, int c0, int n0,
                                              int end, int V) {
  constexpr int PER_ROW = CV_BN / VEC;
  for (int e = threadIdx.x; e < SLAB * PER_ROW; e += blockDim.x) {
    const int r = e / PER_ROW, col = (e - r * PER_ROW) * VEC;
    const bool valid = n0 + col < end;
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

// slab (tile, kt) of a block's columns [c0, c1) into stage u % CV_STAGES;
// one commit group per slab (empty past the end)
template <int VEC>
__device__ __forceinline__ void issue_cv(bf16* stages, int u, int total, int tile, int kt,
                                         const bf16* __restrict__ emb_t, int c0, int c1, int V) {
  if (u < total)
    load_cv_stage<VEC>(stages + (u % CV_STAGES) * SLAB * CV_LDB, emb_t, kt * SLAB, c0 + tile * CV_BN, c1, V);
  cp_async_commit();
}

template <int VEC, int MT>
__global__ void __launch_bounds__(CV_WARPS * 32)
logits_cv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ emb_t, float* __restrict__ out, int xb,
                 int C, int V) {
  extern __shared__ float4 smem4[];
  const int ldx = C + 8;
  bf16* stages = reinterpret_cast<bf16*>(smem4);     // CV_STAGES x (SLAB, CV_LDB)
  bf16* xs = stages + CV_STAGES * SLAB * CV_LDB;     // (xb + 1, ldx): the x rows, then a row of zeros
  int q0, q1;  // this block's 16-column units, then its columns
  balanced((V + 15) / 16, q0, q1);
  const int c0 = q0 * 16, c1 = min(V, q1 * 16);
  const int nk = C / SLAB, total = (c1 - c0 + CV_BN - 1) / CV_BN * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int it = 0, ik = 0;  // the next slab to ask for: its tile and its k slab
#pragma unroll
  for (int s = 0; s < CV_STAGES - 1; ++s) {
    issue_cv<VEC>(stages, s, total, it, ik, emb_t, c0, c1, V);
    if (++ik == nk) ik = 0, ++it;
  }
  stage_x(xs, ldx, xb + 1, x, xb, C);
  // the A rows of m tile m: x row 16 m + lane % 16, or the zero row past xb
  const bf16* arow[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) arow[m] = xs + min(16 * m + (lane & 15), xb) * ldx + (lane >> 4) * 8;
  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  int u = 0;
  for (int tile = 0; u < total; ++tile) {
    for (int kt = 0; kt < nk; ++kt, ++u) {
      cp_async_wait<CV_STAGES - 2>();
      __syncthreads();  // slab u is in (and the x rows); slab u - 1 is consumed
      issue_cv<VEC>(stages, u + CV_STAGES - 1, total, it, ik, emb_t, c0, c1, V);
      if (++ik == nk) ik = 0, ++it;
      const bf16* bs = stages + (u % CV_STAGES) * SLAB * CV_LDB;
#pragma unroll
      for (int kk = 0; kk < SLAB; kk += 16) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * CV_LDB + warp * 16 + (lane >> 4) * 8);
        const uint32_t b_lo[2] = {r[0], r[1]}, b_hi[2] = {r[2], r[3]};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, arow[m] + kt * SLAB + kk);
          mma_bf16_m16n8k16(acc[m][0], a, b_lo);
          mma_bf16_m16n8k16(acc[m][1], a, b_hi);
        }
      }
    }
    // the tile's last slab: its logits are done
    const int n0 = c0 + tile * CV_BN + warp * 16;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = 16 * m + g + 8 * (e >> 1), v = n0 + 8 * j + 2 * t + (e & 1);
          if (b < xb && v < c1) out[(size_t)b * V + v] = acc[m][j][e];
          acc[m][j][e] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// the persistent grid of a kernel at `threads` and `smem`: the SM count
// times the blocks an SM holds, at most one block per `units` of work
template <typename K>
int persistent_grid(K kernel, int threads, size_t smem, int units, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = max(1, min(sms * per_sm, units));
  return 0;
}

size_t vc_smem(int xb, int C) {
  const int kpad = (C + VC_K - 1) / VC_K * VC_K;
  return 1024 + (size_t)VC_STAGES * STAGE_BYTES + (size_t)xb * (kpad + 8) * sizeof(bf16) +
         2 * VC_STAGES * sizeof(uint64_t);
}

size_t cv_smem(int xb, int C) {
  return ((size_t)(xb + 1) * (C + 8) + (size_t)CV_STAGES * SLAB * CV_LDB) * sizeof(bf16);
}

int launch_vc(const bf16* x, const bf16* w, float* o, int xb, int C, int V, cudaStream_t s) {
  const int kpad = (C + VC_K - 1) / VC_K * VC_K;
  const size_t smem = vc_smem(xb, C);
  const uint64_t dims[2] = {(uint64_t)C, (uint64_t)V};
  const uint64_t strides[1] = {(uint64_t)C * sizeof(bf16)};
  const uint32_t box[2] = {VC_K, 16};
  CUtensorMap tw;
  if (hopper::make_tmap_bf16(&tw, w, 2, dims, strides, box) != 0) return (int)cudaErrorInvalidValue;
#define VC(NT)                                                                                   \
  do {                                                                                           \
    int grid = 0;                                                                                \
    if (int e = persistent_grid(logits_vc_kernel<NT>, VC_THREADS, smem, (V + 15) / 16, &grid))   \
      return e;                                                                                  \
    logits_vc_kernel<NT><<<grid, VC_THREADS, smem, s>>>(tw, x, o, xb, C, V, kpad);               \
  } while (0)
  if (xb <= 8) VC(1);
  else if (xb <= 16) VC(2);
  else if (xb <= 32) VC(4);
  else VC(8);
#undef VC
  return (int)cudaGetLastError();
}

int launch_cv(const bf16* x, const bf16* w, float* o, int xb, int C, int V, cudaStream_t s) {
  const int mt = (xb + 15) / 16;
  const size_t smem = cv_smem(xb, C);
#define CV(VEC, MT)                                                                                   \
  do {                                                                                                \
    int grid = 0;                                                                                     \
    if (int e = persistent_grid(logits_cv_kernel<VEC, MT>, CV_WARPS * 32, smem, (V + 15) / 16, &grid)) \
      return e;                                                                                       \
    logits_cv_kernel<VEC, MT><<<grid, CV_WARPS * 32, smem, s>>>(x, w, o, xb, C, V);                   \
  } while (0)
#define CV_ROWS(VEC)       \
  do {                     \
    if (mt <= 1) CV(VEC, 1); \
    else if (mt <= 2) CV(VEC, 2); \
    else CV(VEC, 4);       \
  } while (0)
  if (V % 8 == 0) CV_ROWS(8);
  else if (V % 2 == 0) CV_ROWS(2);
  else CV_ROWS(1);
#undef CV_ROWS
#undef CV
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, V) f32 = x (B, C) . emb^T, emb (V, C) (layout 0, "vc") or its
// (C, V) copy (layout 1, "cv"); bf16, contiguous, 16-byte aligned; C a
// multiple of 32; rows in launches of at most MAX_XB, fewer where the x
// rows and the ring would not fit a block's shared memory
extern "C" int logits_streamed(int layout, int B, int C, int V, const void* x, const void* emb,
                               void* out, void* stream) {
  if (B < 1 || C < SLAB || C % SLAB != 0 || V < 1 || (layout != 0 && layout != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(emb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(emb);
  float* o = static_cast<float*>(out);
  int per = MAX_XB;
  while (per > 1 && (layout == 0 ? vc_smem(per, C) : cv_smem(per, C)) > SMEM_MAX) per /= 2;
  if ((layout == 0 ? vc_smem(1, C) : cv_smem(1, C)) > SMEM_MAX) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < B; b0 += per) {
    const int rows = min(per, B - b0);
    const int e = layout == 0 ? launch_vc(xb + (size_t)b0 * C, w, o + (size_t)b0 * V, rows, C, V, s)
                              : launch_cv(xb + (size_t)b0 * C, w, o + (size_t)b0 * V, rows, C, V, s);
    if (e != 0) return e;
  }
  return 0;
}
