// K1: encoder self-attention, (B, H, T, D) -> (B, H, T, D), non-causal, at
// head dim D = 64 (every Whisper model) or 128 (whisper_tpu's kernel takes
// both, whisper_tpu/ops/attention.py:128).
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
// memory.  bf16 inputs run both products on the tensor cores by wgmma
// (encoder_attention_wgmma_kernel); f32 inputs run them on the CUDA cores
// in f32 (encoder_attention_kernel), whose ceiling is the 67 TFLOP/s f32
// rate and, with 4x4 register tiles, shared-memory bandwidth below that.
//
// Design: the TPU kernel keeps one head's whole K/V (T x D) in VMEM and
// computes an exact softmax per 512-row query block.  227 KB of shared
// memory does not hold that at useful occupancy, so both kernels are
// flash-style forwards: a block per (batch*head, query tile) loops over
// key tiles with an online max and sum, f32 accumulators, and the divide
// at the end.
//
// bf16 (hopper.cuh's blocks): one producer warpgroup whose first thread
// loads the Q tile once and the K and V tiles through a ring of stages by
// TMA (128-byte swizzle; a 3-D map (D, T, B*H), so a head's last tile
// reads zeros past T, never the next head's keys; those keys are still
// masked to -inf, since a zero key is not a masked one).  D = 128 rows
// (256 bytes) load as two 64-column boxes.  NC consumer warpgroups own 64
// query rows each: S = Q K^T by wgmma from shared memory into registers;
// the online softmax on the accumulators (a row's scores in a lane quad,
// max by two shuffles; exp2 with D^-0.5 log2(e) folded into one scale,
// applied to the exact product of the bf16 q and k); P rounded to bf16 in
// registers becomes the A operand of O += P V (wgmma RS; V an MN-major B);
// the rescale of O and the final divide stay in registers.  The f32
// denominator is summed from the rounded weights.  Weights are rounded
// relative to the running max of the key tiles seen so far (BKN keys a
// tile), not the row's global max: that moves the rounding point, as the
// TPU kernel's own deferred normalisation does; K1's bf16 bounds hold at
// T = 1500, 577, 129, 100 and 1 (tests/test_torch_cuda.py).
//
// Tiles (query warpgroups NC, keys per tile BKN, ring stages): NC = 2
// (128 query rows a block), BKN = 128, two stages, at both head dims,
// chosen by timing builds of this kernel with other values on an H100
// 80GB HBM3 at 700 W at (1 and 16, 20, 1500, 64) and (1 and 16, 10, 1500,
// 128) (PERF.md section 6 holds the table).  64-key tiles take 9-17%
// longer (twice the barrier waits, rescales and wgmma batches per key);
// at D = 128 one consumer warpgroup a block (two blocks an SM) takes
// 32-42% longer than two in one block, which share each K and V tile and
// interleave one's softmax with the other's products; at D = 64 the two
// are within 3%, as are three stages against two.  At batch 1 the 240
// blocks of (1, 20, 1500, 64) fill 132 SMs in under two waves.
//
// f32: the query tile, one K tile, one V tile and the weight tile live in
// shared memory (4 x 64 x 68 floats = 68 KB at D = 64, rows padded by 4
// floats so the float4 reads of neighbouring rows fall in distinct banks;
// 116 KB at D = 128, the weight tile keeping its 68-float stride); each of
// the 256 threads owns rows {ty + 16 i} x columns {tx + 16 j}, i < 4, j <
// D / 16.  In f32 the running-max rounding is the same function.

#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int LDP = BK + 4;   // the f32 weight tile's row stride, floats
constexpr int THREADS = 256;

// the padded shared row stride of a (64, HD) f32 tile, and the f32
// kernel's shared memory: Q, K and V tiles and the weight tile
template <int HD>
__host__ __device__ constexpr int lds() { return HD + 4; }
template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return (3 * BQ * lds<HD>() + BQ * LDP) * sizeof(float);
}

// rows [row0, row0 + 64) of a (T, HD) row-major matrix into
// tile[64][HD + 4], times scale; rows at or past T read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src,
                                          int row0, int n_rows, float scale) {
  constexpr int LDS = lds<HD>();
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int n,
                         float scale) {
  constexpr int LDS = lds<HD>();
  constexpr int JO = HD / 16;  // output columns {tx + 16 j}, j < JO, per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDS;
  float* Vs = Ks + BK * LDS;
  float* Ps = Vs + BK * LDS;

  const size_t base = (size_t)blockIdx.y * n * HD;
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, HD>(Qs, q + base, q0, n, scale);

  float m[4], l[4], acc[4][JO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JO; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    load_tile<T, HD>(Ks, k + base, k0, n, scale);
    load_tile<T, HD>(Vs, v + base, k0, n, 1.f);
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
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < JO; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[i][j] += sum_c P[ty + 16 i][c] * V[c][tx + 16 j]
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vb[JO];
#pragma unroll
        for (int j = 0; j < JO; ++j) vb[j] = Vs[(c + cc) * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int j = 0; j < JO; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < n) {
#pragma unroll
      for (int j = 0; j < JO; ++j)
        o[base + (size_t)row * HD + tx + 16 * j] = from_f<T>(acc[i][j] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: a flash-attention forward for Hopper (see the header).  The block
// is NC consumer warpgroups of 64 query rows each and one producer
// warpgroup, whose first thread issues every TMA load: the Q tile once,
// then K and V tiles of BKN keys through a ring of STAGES stages, each
// stage's K and V on their own "full" barrier (so S can start while V is
// still in flight) and freed by the consumer warps on "empty" barriers.
// Tiles live in shared memory as 64-column boxes of 128-byte rows, in
// TMA's 128-byte swizzle: a (R, HD) tile is HD / 64 boxes of R x 128 bytes.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// the bf16 kernel's tiles, the same at both head dims (header): NC consumer
// warpgroups of 64 query rows, BKN keys a tile, STAGES ring stages
constexpr int NC = 2, BKN = 128, STAGES = 2;

template <int HD>
struct Layout {
  static constexpr int BQ = 64 * NC;              // query rows per block
  static constexpr int THREADS = 128 * (NC + 1);  // + the producer warpgroup
  static constexpr int PRODUCER_REGS = 40;
  // what the consumers take after the producer gives up its share of the
  // block's 65536 registers (one block an SM), a multiple of 8
  static constexpr int CONSUMER_REGS = (65536 - 128 * PRODUCER_REGS) / (128 * NC) / 8 * 8;
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BKN * HD * 2;   // one K or V tile
  static constexpr int N_BARRIERS = 1 + 4 * STAGES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * N_BARRIERS;
  static_assert(HD % 64 == 0 && CONSUMER_REGS <= 256, "tile shape");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::THREADS, 1)
encoder_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int n,
                               float scale_log2) {
  using L = Layout<HD>;
  constexpr int DB = HD / 64;  // 64-column boxes per row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + L::Q_BYTES;
  uint8_t* Vs = Ks + STAGES * L::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y, q0 = blockIdx.x * L::BQ;
  const int nk = (n + BKN - 1) / BKN;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(k_empty + s, 4 * NC);  // lane 0 of every consumer warp
      hopper::mbar_init(v_empty + s, 4 * NC);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warpgroup; one thread issues the loads
    hopper::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (threadIdx.x == 128 * NC) {
      hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int b = 0; b < DB; ++b) hopper::tma_load_3d(Qs + b * L::BQ * 128, &tq, q_full, 64 * b, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        hopper::mbar_wait(k_empty + s, ph ^ 1);
        hopper::mbar_arrive_expect_tx(k_full + s, L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < DB; ++b)
          hopper::tma_load_3d(Ks + s * L::KV_BYTES + b * BKN * 128, &tk, k_full + s, 64 * b, j * BKN, bh);
        hopper::mbar_wait(v_empty + s, ph ^ 1);
        hopper::mbar_arrive_expect_tx(v_full + s, L::KV_BYTES);
#pragma unroll
        for (int b = 0; b < DB; ++b)
          hopper::tma_load_3d(Vs + s * L::KV_BYTES + b * BKN * 128, &tv, v_full + s, 64 * b, j * BKN, bh);
      }
    }
  } else {  // a consumer warpgroup: query rows q0 + 64 wg ... + 63
    hopper::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8 of this warp's 16
    hopper::mbar_wait(q_full, 0);

    for (int j = 0; j < nk; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;

      // S = Q K^T (64 x BKN), both operands K-major from shared memory
      float sacc[BKN / 2];
      hopper::mbar_wait(k_full + s, ph);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int b = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = hopper::smem_desc(Qs + b * L::BQ * 128 + wg * 64 * 128 + off, 16, 1024);
        const uint64_t db = hopper::smem_desc(Ks + s * L::KV_BYTES + b * BKN * 128 + off, 16, 1024);
        hopper::wgmma_ss<0>(sacc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sacc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(k_empty + s);

      if (j == nk - 1 && n % BKN != 0) {  // keys past T: zeros from TMA, masked here
#pragma unroll
        for (int i = 0; i < BKN / 2; ++i)
          if (j * BKN + 8 * (i / 4) + 2 * t + (i & 1) >= n) sacc[i] = -INFINITY;
      }

      // online softmax on the accumulators: a row's scores sit in the four
      // lanes of a quad.  Scores in log2 units: s * D^-0.5 * log2(e).
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BKN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // finite: every tile has a valid key
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      // P rounded to bf16 in registers, as PV's A fragments: for k16 step
      // kk, a0 = rows g, keys 16 kk + 2 t (+1); a1 = rows g + 8; a2, a3 the
      // same 8 keys on: the accumulator's d[8 kk .. 8 kk + 7] in order
      uint32_t pfrag[BKN / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < BKN / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 8 * kk + 2 * q, r = q & 1;
          const __nv_bfloat162 p = __floats2bfloat162_rn(exp2f(fmaf(sacc[i], scale_log2, -m[r])),
                                                         exp2f(fmaf(sacc[i + 1], scale_log2, -m[r])));
          const float2 pf = __bfloat1622float2(p);
          rs[r] += pf.x + pf.y;  // the denominator from the rounded weights
          pfrag[kk][q] = *reinterpret_cast<const uint32_t*>(&p);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // this lane's part of the row sum
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];

      // O += P V: V (BKN keys x HD) is MN-major, its boxes LBO apart
      hopper::mbar_wait(v_full + s, ph);
      hopper::fence_operands(oacc);
      hopper::fence_operands(pfrag);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKN / 16; ++kk) {
        const uint64_t db = hopper::smem_desc(Vs + s * L::KV_BYTES + kk * 2048, BKN * 128, 1024);
        hopper::wgmma_rs<1>(oacc, pfrag[kk], db, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(oacc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(v_empty + s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + 64 * wg + 16 * w + g + 8 * h;
      if (row < n) {
        bf16* out = o + ((size_t)bh * n + row) * HD + 2 * t;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
              __floats2bfloat162_rn(oacc[4 * jj + 2 * h] / l[h], oacc[4 * jj + 2 * h + 1] / l[h]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int n,
           cudaStream_t stream) {
  constexpr size_t SMEM_BYTES = smem_bytes<HD>();
  const cudaError_t attr = cudaFuncSetAttribute(
      encoder_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + BQ - 1) / BQ, bh);
  const float scale = (float)pow((double)HD, -0.25);
  encoder_attention_kernel<T, HD><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), n, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bh, int n, cudaStream_t stream) {
  using L = Layout<HD>;
  auto kernel = encoder_attention_wgmma_kernel<HD>;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int setup = hopper::prepare_launch(kernel, NC, L::CONSUMER_REGS, L::PRODUCER_REGS, L::SMEM);
  if (setup != 0) return setup;
  // (D, T, B*H): the box of a head's last tile stops at T, zero-filled
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)n, (uint64_t)bh};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)n * HD * 2};
  const uint32_t qbox[3] = {64, (uint32_t)L::BQ, 1}, kvbox[3] = {64, (uint32_t)BKN, 1};
  CUtensorMap tq, tk, tv;
  if (hopper::make_tmap_bf16(&tq, q, 3, dims, strides, qbox) != 0 ||
      hopper::make_tmap_bf16(&tk, k, 3, dims, strides, kvbox) != 0 ||
      hopper::make_tmap_bf16(&tv, v, 3, dims, strides, kvbox) != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + L::BQ - 1) / L::BQ, bh);
  const float scale_log2 = (float)(1.0 / sqrt((double)HD) * 1.4426950408889634);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(o), n, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int encoder_attention(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int bh, int n,
                                 int head_dim, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || bh <= 0 || bh > 65535 || n <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return head_dim == 64 ? launch_wgmma<64>(q, k, v, o, bh, n, s) : launch_wgmma<128>(q, k, v, o, bh, n, s);
  if (dtype == DTYPE_F32)
    return head_dim == 64 ? launch<float, 64>(q, k, v, o, bh, n, s)
                          : launch<float, 128>(q, k, v, o, bh, n, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
