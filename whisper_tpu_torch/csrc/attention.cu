// K1: encoder self-attention, (B, H, T, D) -> (B, H, T, D), non-causal.
//
// Replaces whisper_tpu/ops/kernels/attention_pallas.py:attention_pallas
// (body _attn_kernel).  Same math: q and k each scaled by D^-0.25 in f32,
// f32 scores, keys past T masked, exp weights rounded to the compute dtype
// before they feed PV, the f32 denominator summed from those rounded
// weights, and the divide after PV.
//
// What bounds it on an H100: at T = 1500, D = 64 the two products are
// 4*T*T*D flops per (batch, head) against 4*T*D elements of traffic, about
// 750 flops per byte in bf16, so it is bound by arithmetic, not by device
// memory.  bf16 inputs run both products on the tensor cores (WMMA, f32
// accumulate; encoder_attention_tc_kernel); f32 inputs run them on the
// CUDA cores in f32 (encoder_attention_kernel), whose ceiling is the
// 67 TFLOP/s f32 rate and, with 4x4 register tiles, shared-memory
// bandwidth below that.
//
// Design: the TPU kernel keeps one head's whole K/V (T x D) in VMEM and
// computes an exact softmax per 512-row query block.  227 KB of shared
// memory does not hold that at useful occupancy, so this is a flash-style
// forward: one block per (batch*head, 64-query tile) loops over 64-key
// tiles with an online max and sum, f32 accumulators, and the divide at the
// end.  In the f32 kernel the query tile, one K tile, one V tile and the
// weight tile live in shared memory (4 x 64 x 68 floats = 68 KB, rows
// padded by 4 floats so the float4 reads of neighbouring rows fall in
// distinct banks); each of the 256 threads owns rows {ty + 16 i} x columns
// {tx + 16 j}, i, j < 4.  Rounding the weights to bf16 relative to the
// running max instead of the global max moves the rounding point (as the
// TPU kernel's own deferred normalisation does); in f32 it is the same
// function.  Wgmma, TMA and a producer warp are later work.

#include <mma.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int LDS = HD + 4;   // padded shared row stride, floats
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = 4 * BQ * LDS * sizeof(float);

// rows [row0, row0 + 64) of a (T, 64) row-major matrix into tile[64][LDS],
// times scale; rows at or past T read as zeros
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int row0, int n_rows, float scale) {
  constexpr int V = Vec16<T>::N;
  constexpr int PER_ROW = HD / V;
  for (int e = threadIdx.x; e < BQ * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * V;
    float vals[V];
    if (row0 + r < n_rows) {
      load16(src + (size_t)(row0 + r) * HD + c, vals);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) vals[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) tile[r * LDS + c + u] = vals[u] * scale;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int n,
                         float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDS;
  float* Vs = Ks + BK * LDS;
  float* Ps = Vs + BK * LDS;

  const size_t base = (size_t)blockIdx.y * n * HD;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T>(Qs, q + base, q0, n, scale);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile<T>(Ks, k + base, k0, n, scale);
    load_tile<T>(Vs, v + base, k0, n, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LDS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LDS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (k0 + tx + 16 * j >= n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // online softmax; a row's 64 scores sit in the 16 lanes sharing ty
    // (lanes 0-15 or 16-31 of a warp), so xor-shuffles 8..1 reduce a row.
    // Every tile holds at least one valid key, so the max is finite.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = round_to<T>(expf(s[i][j] - m_new));
        Ps[(ty + 16 * i) * LDS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i][j] += sum_c P[ty + 16 i][c] * V[c][tx + 16 j]
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) vb[j] = Vs[(c + cc) * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[base + (size_t)row * HD + tx + 16 * j] = from_f<T>(acc[i][j] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same flash-style forward with both products on the tensor cores
// (WMMA 16x16x16, bf16 in, f32 accumulate).  Four warps per 64-query tile,
// each owning 16 query rows.  Per 64-key tile a warp computes its S = Q K^T
// block into shared memory, runs the online softmax on it (two lanes per
// row, 32 columns each), writes the rounded weights P as bf16, multiplies
// P V into shared memory and folds that into per-lane f32 accumulators
// (row lane/2, 32 columns), which carry the running rescale.  The scale is
// applied once to the scores, as D^-0.25 * D^-0.25 on the exact bf16
// product, instead of to q and k separately.
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;      // 4 warps x 16 query rows
constexpr int LDH = HD + 8;          // bf16 tile row stride (elements)
constexpr int LDF = BK + 4;          // f32 tile row stride (elements)
constexpr size_t TC_SMEM_BYTES = 4 * BQ * LDH * sizeof(bf16) + BQ * LDF * sizeof(float);

// rows [row0, row0 + 64) of a (T, 64) bf16 matrix into tile[64][LDH];
// rows at or past T read as zeros
__device__ __forceinline__ void load_tile_bf16(bf16* tile, const bf16* __restrict__ src,
                                               int row0, int n_rows) {
  for (int e = threadIdx.x; e < BQ * (HD / 8); e += TC_THREADS) {
    const int r = e / (HD / 8), c = (e % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    *reinterpret_cast<uint4*>(tile + r * LDH + c) = v;
  }
}

__global__ void __launch_bounds__(TC_THREADS)
encoder_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o, int n,
                            float scale2) {
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + BQ * LDH;
  bf16* Vs = Ks + BK * LDH;
  bf16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + BQ * LDH);  // S, then this tile's P V

  const size_t base = (size_t)blockIdx.y * n * HD;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 1);  // this lane's query row in the tile
  const int half = (lane & 1) * 32;         // and its 32 columns

  load_tile_bf16(Qs, q + base, q0, n);
  float m = -INFINITY, l = 0.f, acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs are no longer read
    load_tile_bf16(Ks, k + base, k0, n);
    load_tile_bf16(Vs, v + base, k0, n);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {  // S[16 rows][16 keys] blocks
      wm::fragment<wm::accumulator, 16, 16, 16, float> s;
      wm::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> b;  // K^T
        wm::load_matrix_sync(a, Qs + 16 * warp * LDH + 16 * kk, LDH);
        wm::load_matrix_sync(b, Ks + 16 * j * LDH + 16 * kk, LDH);
        wm::mma_sync(s, a, b, s);
      }
      wm::store_matrix_sync(Ss + 16 * warp * LDF + 16 * j, s, LDF, wm::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's 32 scores; its row partner is lane ^ 1
    const float* srow = Ss + row * LDF + half;
    float s[32], mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      s[c] = (k0 + half + c < n) ? srow[c] * scale2 : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: every tile has a valid key
    const float corr = expf(m - m_new);
    bf16* prow = Ps + row * LDH + half;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const bf16 p = __float2bfloat16_rn(expf(s[c] - m_new));
      prow[c] = p;
      rs += __bfloat162float(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {  // (P V)[16 rows][16 dims] blocks
      wm::fragment<wm::accumulator, 16, 16, 16, float> pv;
      wm::fill_fragment(pv, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> a;
        wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> b;
        wm::load_matrix_sync(a, Ps + 16 * warp * LDH + 16 * kk, LDH);
        wm::load_matrix_sync(b, Vs + 16 * kk * LDH + 16 * j, LDH);
        wm::mma_sync(pv, a, b, pv);
      }
      wm::store_matrix_sync(Ss + 16 * warp * LDF + 16 * j, pv, LDF, wm::mem_row_major);
    }
    __syncwarp();
    const float* orow = Ss + row * LDF + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = acc[c] * corr + orow[c];
    __syncwarp();  // orow is read before the next tile's S overwrites it
  }

  if (q0 + row < n) {
    bf16* out = o + base + (size_t)(q0 + row) * HD + half;
#pragma unroll
    for (int c = 0; c < 32; ++c) out[c] = __float2bfloat16_rn(acc[c] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n,
           cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      encoder_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  const float scale = (float)pow((double)HD, -0.25);
  encoder_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, scale);
  return (int)cudaGetLastError();
}

int launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int n,
              cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      encoder_attention_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TC_SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  const float scale = (float)pow((double)HD, -0.25);
  encoder_attention_tc_kernel<<<grid, TC_THREADS, TC_SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), n, scale * scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int encoder_attention(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int bh, int n,
                                 int head_dim, void* stream) {
  if (head_dim != HD || bh <= 0 || bh > 65535 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return launch_tc(q, k, v, o, bh, n, s);
  if (dtype == DTYPE_F32) return launch<float>(q, k, v, o, bh, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
