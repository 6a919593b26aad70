// The encoder block's projections and LayerNorm, each one pass over its
// activations (bf16 only).
//
// Replaces no TPU kernel: whisper_tpu leaves the encoder's projections,
// bias adds, GELU, residual adds and LayerNorms to XLA, which fuses the
// pointwise work into the products.  On the card the same block in plain
// PyTorch (models.whisper._encoder_block's torch route) makes about twenty
// pointwise passes a layer around its library products; these two kernels
// make none.
//
// 1. encoder_linear: out = epilogue(round(x @ w^T)), x (rows, K), w (N, K)
// as the port keeps its weights, (out, in), so that no weight is copied.
// The epilogue rounds where _linear and the block round: round(acc), then
// + bias rounded (when there is a bias), then one of nothing more (q, k,
// v), erf-GELU rounded (fc1), + residual rounded (o, fc2).  Layouts beyond
// row-major: up to three weights (q, k and v) share one launch, each with
// its own bias and output, the outputs stored in K1's (B, H, T, D) layout
// (the three split_heads copies go); the input may be K1's (B, H, T, D)
// output itself, read in place through a 3-D tensor map (merge_heads' copy
// goes).
//
// What bounds it on an H100: 2 M K N operations against (M K + N K + M N)
// elements (and M N more for the residual): at the encoder's shapes (M =
// 1500 B, K and N of 1280 and 5120) 600-1300 operations a byte, above the
// 295 where the tensor cores become the limit, so it is bound by
// arithmetic; at B = 1 a projection is 5-20 GFLOP, 5-20 us at 989 TFLOP/s,
// and the wave of tiles over 132 SMs decides as much as the rate.
//
// Design: E1's (matmul_residual.cu) persistent TMA + wgmma GEMM with both
// operands K-major.  One block per SM walks the BM x BN output tiles
// (the column tiles of one row tile in turn, so the blocks in flight share
// their x rows in L2; every weight fits in the 50 MB L2).  A producer
// warpgroup (one thread) keeps a ring of stages full by TMA: x's (128
// rows, 64 K) box and w's (BN rows, 64 K) box, both K-major in the 128-byte
// swizzle (hopper.cuh).  Two consumer warpgroups own 64 rows each and run
// wgmma m64nBNk16 with f32 accumulators, one K step's four wgmmas kept in
// flight while the previous step's stage is released.  The epilogue
// rounds in registers and writes the tile into shared memory in TMA's
// swizzled boxes (the residual tile, loaded there by TMA during the
// products, is read and overwritten in place); one thread then stores the
// tile by TMA and the consumers go on to the next tile's products while
// the store drains.  E1's epilogue loads and stores 4 bytes a thread
// straight from registers, which at K = 1280 took longer than the
// products (about 21 us against 12 a 128 x 256 tile, H100).  BN is 256 or
// 128, chosen by the caller from the tile count (a 128-wide tile fills the
// 132 SMs at B = 1).  Rows are tiled per group (an audio's T frames), so a
// tile never spans two audios and K1's layout is read and written by
// 3-D tensor maps; rows past T and columns past N are neither loaded nor
// stored (TMA clips them).  Contract: K a multiple of 32 (TMA fills the
// last K step with zeros), N of 8; every pointer 16-byte aligned; for
// K1's layouts the head dim D a multiple of 64, dividing K (in) or N
// (out).
//
// 2. layer_norm_rows: LayerNorm over the last dim as models.whisper.
// layer_norm computes it: f32 mean and variance without correction, (x -
// mean) * rsqrt(var + 1e-5) * g + b, each operation rounded in f32 (no
// fused multiply-add), one rounding to bf16.  Bound by bytes (one read and
// one write of the rows, 7.7 MB at 1500 x 1280: 2.3 us at 3.35 TB/s).  One
// warp a row, the row in registers (16-byte loads), two warp reductions.

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128, BKT = 64, THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int K_MULTIPLE = 32, MAX_SEGMENTS = 3;
constexpr uint32_t A_BYTES = BM * BKT * 2;

enum Epilogue : int { EPI_BIAS = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

template <int BN>
struct Tiles {
  // the ring, then the output tile (BN / 64 boxes of 128 rows x 128 bytes)
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr uint32_t B_BYTES = BN * BKT * 2, STAGE_BYTES = A_BYTES + B_BYTES, OUT_BYTES = BM * BN * 2;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + OUT_BYTES + 16 * (STAGES + 1);
};

struct Params {
  CUtensorMap ta;                   // x: 3-D (64-wide K boxes, rows, planes)
  CUtensorMap tw[MAX_SEGMENTS];     // each segment's w (N, K)
  CUtensorMap tout[MAX_SEGMENTS];   // each segment's out: (N, T, G), or K1's (D, T, G N / D)
  CUtensorMap tres;                 // EPI_RESIDUAL: res (N, T, G)
  const bf16* bias[MAX_SEGMENTS];   // or null
  int G, T, K, N, nseg, D;
  int a_heads, out_heads;           // x / out in K1's (G, heads, T, D) layout
};

// PyTorch's erf-GELU on the card: (y * 0.5) * (1 + erf(y / sqrt 2)) in f32
__device__ __forceinline__ float gelu(float y) {
  return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(y, 0.70710678118654752440f))));
}

// the output tile's (and the residual's) 64-column box b = c / 64 of 128
// rows in TMA's 128-byte swizzle: row r's 16-byte chunk q at (q ^ r % 8)
__device__ __forceinline__ uint32_t out_offset(int r, int c) {
  return (c / 64) * (BM * 128) + r * 128 + ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
}

template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) encoder_linear_wgmma_kernel(const __grid_constant__ Params p) {
  using L = Tiles<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tile_out = ring + L::STAGES * L::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_out + L::OUT_BYTES);
  uint64_t* empty = full + L::STAGES;
  uint64_t* res_full = empty + L::STAGES;  // the residual tile has arrived in tile_out
  uint64_t* res_free = res_full + 1;       // tile_out's last TMA stores have read it
  const int wg = threadIdx.x / 128;
  const int tiles_t = (p.T + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN, cols = p.nseg * tiles_n;
  const int tiles = p.G * tiles_t * cols, nk = (p.K + BKT - 1) / BKT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);  // lane 0 of each consumer warp
    }
    hopper::mbar_init(res_full, 1);
    hopper::mbar_init(res_free, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: one thread walks this block's tiles
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      const int heads_in = p.K / p.D;
      int it = 0, n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        const int mt = tile / cols, ct = tile % cols;
        const int g = mt / tiles_t, t0 = (mt % tiles_t) * BM;
        const int seg = ct / tiles_n, n0 = (ct % tiles_n) * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % L::STAGES;
          hopper::mbar_wait(empty + s, ((it / L::STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full + s, L::STAGE_BYTES);
          uint8_t* a = ring + s * L::STAGE_BYTES;
          if (p.a_heads)  // K step kt: columns 64 kt.. of head 64 kt / D
            hopper::tma_load_3d(a, &p.ta, full + s, (kt * BKT) % p.D, t0, g * heads_in + (kt * BKT) / p.D);
          else
            hopper::tma_load_3d(a, &p.ta, full + s, kt * BKT, g * p.T + t0, 0);
          hopper::tma_load_2d(a + A_BYTES, &p.tw[seg], full + s, kt * BKT, n0);
        }
        if constexpr (EPI == EPI_RESIDUAL) {
          // the tile's residual into tile_out, once the last tile's stores
          // have read it (the consumers signal that early in this tile)
          hopper::mbar_wait(res_free, n & 1);
          hopper::mbar_arrive_expect_tx(res_full, L::OUT_BYTES);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            hopper::tma_load_3d(tile_out + b * (BM * 128), &p.tres, res_full, n0 + 64 * b, t0, g);
        }
      }
    }
  } else {  // consumer warpgroup wg: rows t0 + 64 wg ... + 63 of each tile
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32, gr = lane / 4, tq = lane % 4;
    int it = 0, n = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
      const int mt = tile / cols, ct = tile % cols;
      const int g = mt / tiles_t, t0 = (mt % tiles_t) * BM;
      const int seg = ct / tiles_n, n0 = (ct % tiles_n) * BN;
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % L::STAGES;
        hopper::mbar_wait(full + s, (it / L::STAGES) & 1);
        const uint8_t* a = ring + s * L::STAGE_BYTES;
        hopper::fence_operands(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk) {
          // both K-major: this warpgroup's 64 rows of x, BN rows of w
          const uint64_t da = hopper::smem_desc(a + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = hopper::smem_desc(a + A_BYTES + kk * 32, 16, 1024);
          hopper::wgmma_ss<0>(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        if (kt == 0 && threadIdx.x == 0) {
          // while the products run: the last tile's stores have read
          // tile_out, so the residual may load into it
          hopper::bulk_wait_read<0>();
          if constexpr (EPI == EPI_RESIDUAL) hopper::mbar_arrive(res_free);
        }
        // keep this step's products in flight; the previous step's are done
        hopper::wgmma_wait<1>();
        hopper::fence_operands(acc);
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % L::STAGES);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % L::STAGES);

      // the epilogue, from the accumulators into tile_out: d[4 j + 2 h + e]
      // is row 16 w + g + 8 h, column 8 j + 2 t + e of the warpgroup's
      // 64 x BN; then TMA stores it while the next tile's products run.
      // Rows past T and columns past N are computed and not stored
      hopper::named_sync(1, 256);  // thread 0 saw the last stores read tile_out
      if constexpr (EPI == EPI_RESIDUAL) hopper::mbar_wait(res_full, n & 1);
      const bf16* __restrict__ bias = p.bias[seg];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const float2 b = bias != nullptr && n0 + c < p.N
                             ? __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(bias + n0 + c)))
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(tile_out + out_offset(64 * wg + 16 * w + gr + 8 * h, c));
          float y0 = round_to<bf16>(acc[4 * j + 2 * h]), y1 = round_to<bf16>(acc[4 * j + 2 * h + 1]);
          if (bias != nullptr) {
            y0 = round_to<bf16>(y0 + b.x);
            y1 = round_to<bf16>(y1 + b.y);
          }
          if constexpr (EPI == EPI_GELU) {
            y0 = gelu(y0);
            y1 = gelu(y1);
          } else if constexpr (EPI == EPI_RESIDUAL) {
            const float2 r = __bfloat1622float2(*at);
            y0 += r.x;
            y1 += r.y;
          }
          *at = __floats2bfloat162_rn(y0, y1);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 256);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b) {
          const int c = n0 + 64 * b;
          if (c >= p.N) break;
          if (p.out_heads)  // K1's layout: head c / D, its columns c % D..
            hopper::tma_store_3d(&p.tout[seg], tile_out + b * (BM * 128), c % p.D, t0, g * (p.N / p.D) + c / p.D);
          else
            hopper::tma_store_3d(&p.tout[seg], tile_out + b * (BM * 128), c, t0, g);
        }
        hopper::bulk_commit();
      }
    }
    if (threadIdx.x == 0) hopper::bulk_wait<0>();
  }
}

template <int BN, int EPI>
int launch_linear(const Params& p, int sms, cudaStream_t stream) {
  auto kernel = encoder_linear_wgmma_kernel<BN, EPI>;
  const int setup = hopper::prepare_launch(kernel, 2, CONSUMER_REGS, PRODUCER_REGS, Tiles<BN>::SMEM);
  if (setup != 0) return setup;
  const long long tiles =
      (long long)p.G * ((p.T + BM - 1) / BM) * p.nseg * ((p.N + BN - 1) / BN);
  const int blocks = tiles < sms ? (int)tiles : sms;  // persistent: at most one block per SM
  kernel<<<blocks, THREADS, Tiles<BN>::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_linear(int epilogue, const Params& p, int sms, cudaStream_t stream) {
  switch (epilogue) {
    case EPI_BIAS: return launch_linear<BN, EPI_BIAS>(p, sms, stream);
    case EPI_GELU: return launch_linear<BN, EPI_GELU>(p, sms, stream);
    case EPI_RESIDUAL: return launch_linear<BN, EPI_RESIDUAL>(p, sms, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// LayerNorm: one warp a row of C bf16 (C a multiple of 8, at most 8 * 32 *
// LN_CHUNKS), eight rows a block
constexpr int LN_CHUNKS = 8, LN_WARPS = 8;

__global__ void __launch_bounds__(32 * LN_WARPS)
layer_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gain, const bf16* __restrict__ bias,
                       bf16* __restrict__ out, long long rows, int C) {
  const long long row = (long long)blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32, chunks = C / 8;
  const bf16* xr = x + row * C;
  float v[LN_CHUNKS][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      load16(xr + 8 * ch, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_sum(sum) / (float)C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = __fsub_rn(v[i][e], mean);
        sq = __fmaf_rn(v[i][e], v[i][e], sq);
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(warp_sum(sq) / (float)C, 1e-5f));
#pragma unroll
  for (int i = 0; i < LN_CHUNKS; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      float g[8], b[8];
      load16(gain + 8 * ch, g);
      load16(bias + 8 * ch, b);
      uint4 packed;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(v[i][2 * e], rstd), g[2 * e]), b[2 * e]);
        const float y1 = __fadd_rn(__fmul_rn(__fmul_rn(v[i][2 * e + 1], rstd), g[2 * e + 1]), b[2 * e + 1]);
        o[e] = __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<uint4*>(out + row * C + 8 * ch) = packed;
    }
  }
}

}  // namespace

// out_s = epilogue(round(x @ w_s^T) (+ bias_s)) for each of nseg (1-3)
// segments s: x (G T, K) row-major, or with a_heads (G, K / D, T, D); w_s
// (N, K) row-major; bias_s (N,) or null; res (G T, N) for the residual
// epilogue; out_s (G T, N), or with out_heads (G, N / D, T, D).
// epilogue: 0 bias only, 1 erf-GELU, 2 + res.  bn: the column tile, 128 or
// 256.  All bf16, 16-byte aligned; K a multiple of 32, N of 8; D a multiple
// of 64 for either of K1's layouts.
extern "C" int encoder_linear(int epilogue, int bn, int a_heads, int out_heads, int nseg, const void* x,
                              const void* w0, const void* w1, const void* w2, const void* b0, const void* b1,
                              const void* b2, const void* res, void* o0, void* o1, void* o2, int G, int T, int K,
                              int N, int D, void* stream) {
  if (G < 1 || T < 1 || D < 1 || K < K_MULTIPLE || K % K_MULTIPLE != 0 || N < 8 || N % 8 != 0 || nseg < 1 ||
      nseg > MAX_SEGMENTS || (bn != 128 && bn != 256) || (epilogue == EPI_RESIDUAL) != (res != nullptr))
    return (int)cudaErrorInvalidValue;
  if ((a_heads && (D % BKT != 0 || K % D != 0)) || (out_heads && (D % BKT != 0 || N % D != 0)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  const void* ws[MAX_SEGMENTS] = {w0, w1, w2};
  const void* bs[MAX_SEGMENTS] = {b0, b1, b2};
  void* os[MAX_SEGMENTS] = {o0, o1, o2};
  if (!aligned16(x) || !aligned16(res)) return (int)cudaErrorMisalignedAddress;
  // out and res (N, T, G), or K1's (D, T, G N / D), in boxes of 64 columns x 128 rows
  const uint64_t odims[3] = {out_heads ? (uint64_t)D : (uint64_t)N, (uint64_t)T,
                             out_heads ? (uint64_t)G * (N / D) : (uint64_t)G};
  const uint64_t ostrides[2] = {odims[0] * 2, odims[0] * T * 2};
  const uint64_t rdims[3] = {(uint64_t)N, (uint64_t)T, (uint64_t)G}, rstrides[2] = {(uint64_t)N * 2,
                                                                                     (uint64_t)N * T * 2};
  const uint32_t obox[3] = {64, BM, 1};
  for (int s = 0; s < nseg; ++s) {
    if (ws[s] == nullptr || os[s] == nullptr) return (int)cudaErrorInvalidValue;
    if (!aligned16(ws[s]) || !aligned16(bs[s]) || !aligned16(os[s])) return (int)cudaErrorMisalignedAddress;
    // w_s (N, K) in boxes of 64 K x bn rows
    const uint64_t wdims[2] = {(uint64_t)K, (uint64_t)N}, wstrides[1] = {(uint64_t)K * 2};
    const uint32_t wbox[2] = {BKT, (uint32_t)bn};
    if (hopper::make_tmap_bf16(&p.tw[s], ws[s], 2, wdims, wstrides, wbox) != 0 ||
        hopper::make_tmap_bf16(&p.tout[s], os[s], 3, odims, ostrides, obox) != 0)
      return (int)cudaErrorInvalidValue;
    p.bias[s] = static_cast<const bf16*>(bs[s]);
  }
  if (res != nullptr && hopper::make_tmap_bf16(&p.tres, res, 3, rdims, rstrides, obox) != 0)
    return (int)cudaErrorInvalidValue;
  // x in boxes of 64 K x 128 rows: (K, G T, 1), or K1's (D, T, G K / D)
  const uint64_t rows = (uint64_t)G * T;
  const uint64_t xdims[3] = {a_heads ? (uint64_t)D : (uint64_t)K, a_heads ? (uint64_t)T : rows,
                             a_heads ? (uint64_t)G * (K / D) : 1};
  const uint64_t xstrides[2] = {xdims[0] * 2, xdims[0] * xdims[1] * 2};
  const uint32_t xbox[3] = {BKT, BM, 1};
  if (hopper::make_tmap_bf16(&p.ta, x, 3, xdims, xstrides, xbox) != 0) return (int)cudaErrorInvalidValue;
  p.G = G, p.T = T, p.K = K, p.N = N, p.nseg = nseg, p.D = D, p.a_heads = a_heads, p.out_heads = out_heads;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms <= 0)
    return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 256 ? launch_linear<256>(epilogue, p, sms, s) : launch_linear<128>(epilogue, p, sms, s);
}

// out (rows, C) = LayerNorm(x (rows, C)) * g + b, bf16, C a multiple of 8 up
// to 2048, 16-byte aligned
extern "C" int layer_norm_rows(const void* x, const void* g, const void* b, void* out, long long rows, int C,
                               void* stream) {
  if (rows < 1 || C < 8 || C % 8 != 0 || C > 8 * 32 * LN_CHUNKS) return (int)cudaErrorInvalidValue;
  for (const void* ptr : {x, g, b, static_cast<const void*>(out)})
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  const long long blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  layer_norm_rows_kernel<<<(unsigned)blocks, 32 * LN_WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), rows, C);
  return (int)cudaGetLastError();
}
