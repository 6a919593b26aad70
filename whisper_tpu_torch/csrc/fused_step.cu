// K2: one decode step through all L decoder layers, for B rows of A audios,
// each row at its own position; and K5, its MLP stage on its own.
//
// Replaces whisper_tpu/ops/kernels/fused_step_pallas.py:fused_decoder_layers
// in all its variants, unquantized and int8, with and without a pending
// block, and the XLA steps it leaves beam and best-of groups of several
// audios to (models/whisper.decoder_step(..., n_group=G) and
// decoder_step_pending(..., n_group=G)): B rows with their own
// self-KV caches and positions t[b] (a device int32 vector, or one host
// int shared by every row), A audios with
// A | B, G = B / A rows per audio, group-major (row b reads audio b / G's
// cross K/V).  B = 1 is greedy, A = 1 a beam or best-of group of one file,
// A = B one row per file of a batch, A x G the groups of a batch.  Same
// contract: input x (B, C) is the token + position embedding; outputs are
// the hidden state after the last layer (no final LayerNorm) and each
// layer's new K/V as (L, B, C); the KV-cache column write stays with the
// caller.  Per layer: ln1 -> q, k, v -> self-attention over the row's cache
// positions < t[b] (all T of them for t[b] >= T) plus the new token -> o +
// residual -> ln2 -> xq -> cross-attention over Ta -> xo + residual -> ln3
// -> fc1 + GELU -> fc2 + residual.
// LayerNorm statistics, softmax and every accumulation are f32; each
// intermediate is rounded to the compute dtype where models.whisper's
// decoder_step rounds it.
//
// What bounds it on an H100: every weight is read once per step for 2 * B
// flops per element, and cross-attention reads 2 * H * D * Ta cache
// elements per layer, so the step is bound by device-memory bytes
// (large-v3-turbo, bf16: ~46 MB of weights and ~7.7 MB of cross K/V per
// layer) and, at four layers, by the fixed cost of its launches.  The
// grouped form keeps that byte count at any B <= 16: the rows share each
// weight row's read (the point of the TPU kernel's grouped layout) and each
// audio's cross K/V read.  Above 16 rows the GEMVs run in row tiles of 16
// (a grid dimension), each tile reading the weights once, so the weight
// bytes grow with ceil(B / 16) (the later tiles from L2: a weight block's
// tiles run side by side); A audios read A cross K/Vs once each.
//
// Design: the TPU kernel is one pallas_call whose (layer, phase) grid
// streams weight tiles through VMEM with the residual stream resident.
// Blocks on a GPU run in no order and share nothing, so this form is eight
// launches per layer, queued back to back on one stream by one host call
// (no Python between them):
//   gemv  (LayerNorm prologue, q|k|v in one launch of 3C rows)
//   decode_attention (self: cache positions < t[b] and the new token)
//   gemv  (o, + residual)               gemv (LayerNorm prologue, xq)
//   decode_attention (cross: Ta keys)
//   gemv  (xo, + residual)
//   mlp_stream (LayerNorm prologue, fc1, GELU)   mlp_stream (fc2, + residual)
// (bf16; in f32 the MLP's two launches are GEMVs too).
// The chain runs under programmatic dependent launch (common.cuh Chain):
// each launch after the first may start while the one before it drains.
// Before pdl_wait() a kernel touches only what no launch of the step
// writes: a GEMV asks for its weight rows into L2 (cp.async.bulk.prefetch),
// mlp_stream streams its first weight stages into shared memory,
// decode_attention issues its first cache tiles; after it, it reads x, q,
// the attention output or ff, and then lets the next launch start
// (pdl_trigger), so a launch's weights stream while the one before it
// finishes instead of after.  The first layer's GEMVs read x where the
// others read the hidden state: q|k|v takes its LayerNorm of x and the o
// projection adds its residual to x and writes the hidden state, so no copy
// of x starts the step.  A persistent kernel over all layers with
// grid-wide barriers is later work.
// The GEMV keeps torch's (out, in) weight layout and holds the input rows
// of its block's tile (all B, up to 16) in shared memory.  In f32, and for
// one bf16 row, one warp reads one output row's weights with 16-byte loads
// and dots it against the rows with FMAs on the CUDA cores.  For 2 to 16
// bf16 rows that costs 16 FMAs and 4 shared-memory loads per weight at 16
// rows, 8x the one-row time where the bytes are the same, so those run on
// the tensor cores: mma.sync m16n8k16 with the tile's rows (zero-padded to
// 16) as M and 8 or 16 output rows per block as N, the block's warps
// splitting the inputs (gemv_tc_kernel).  B input rows of fc2 (4C = 5120
// at turbo) do not fit in the 48 KB a launch gets without opting in (B = 5:
// 100 KB in f32), so the block walks the input in chunks (at most 47 KB of
// floats on the CUDA cores, 1280 bf16 per row on the tensor cores); each
// chunk is loaded (and LayerNorm-ed: from the rows in shared memory when
// the input fits in one chunk, else from per-row statistics computed
// first) by the whole block, then the warps accumulate over it.
// decode_attention: the caches are time-last, (H, D, T) per row (or
// audio), so a head's keys are 64 rows of contiguous positions.  A block
// streams tiles of 64 rows x 64 keys into a ring of shared memory with
// 16-byte cp.async copies (8 bf16, 4 f32 or 16 int8 keys a copy; a row of
// an odd-length cache, Ta = 1500 in bf16 or int8, starts inside a 16-byte
// chunk, so each row's copies start at the boundary before its first key
// and the row is read from its offset inside the tile), zero-filling every
// byte at or past the block's last valid key, so a row's tail reads nothing
// of the next row, head or audio.  The K tiles give the scores, then the
// cluster exchanges each block's max and its sum of exp(s - max) once
// (the V tiles are already in flight), each block normalises its weights
// with the exact maximum and denominator and rounds them to the compute
// dtype before PV, as the TPU kernel does (two passes, no online
// softmax), then the V tiles give the partial outputs, which rank 0 sums
// in rank order (deterministic): three cluster barriers.  A (row, head)
// takes split = ceil(keys / 128) blocks for self-attention (two at t = 200,
// four at T = 448 with per-row positions: the launch cannot see the rows'
// positions) and ceil(Ta / 192) for cross-attention (eight at Ta = 1500),
// a thread-block cluster of at most eight; rank 0 also takes the pending
// columns and the new token.  For cross-attention one cluster per (audio,
// head) takes the audio's G queries (up to 8 per cluster) and reads each
// key and value once for all of them, so an audio's K/V leaves device
// memory once per step whatever G is.

// int8 (whisper_tpu's quantize.py; int8 leaves of fused_step_pallas.py's
// weight pack and of its cross K/V): the eight projections may be int8
// (out, in) with f32 scales per output row, and the cross K/V int8 with f32
// scales per (audio, head, channel); either, both or neither.  The int8
// bytes are what leaves device memory: the CUDA-core GEMV takes 16 weights
// per 16-byte load and converts them to f32, the tensor-core GEMV 8 per
// 8-byte load converted to bf16 in registers (both exact for |q| <= 127),
// and the epilogue is round(acc * s[r]), then the bias, GELU and residual
// as before (models.whisper._linear's order).  Cross-attention on int8 K/V
// folds D^-0.5 and the audio's K scales into the query (rounded once), takes
// the keys unscaled, and scales the PV sum by the V scales before it rounds
// (models.whisper._cross_step_attention's int8 branch).  The halved bytes
// bound the step only where it is byte-bound (many rows; one row is bound by
// its launches at this width).
//
// K5 (replaces whisper_tpu/ops/kernels/mlp_pallas.py:mlp_fused_pallas):
// x + fc2(gelu(fc1(LayerNorm(x)))) for 1-128 rows, each weight read once
// per row tile, int8 converted in the kernel.  It is the host function that
// queues K2's MLP stage (mlp_stage), so one implementation serves both: in
// bf16 two launches of mlp_stream_kernel (fc1 with its LayerNorm prologue
// and GELU, then fc2 with the residual), each a persistent grid streaming
// its weights by TMA into mma.sync with the weights as M, fc2's inputs
// split over a thread-block cluster; in f32 the CUDA-core GEMV.  The single
// launch of the TPU kernel (fc2's partial sums over F meeting before its
// epilogue) would need a grid-wide barrier here; the launch boundary that
// Chain orders takes its place.  The int8 logits projection is the GEMV
// with an unrounded f32 epilogue acc * s[v] (int8_logits).
//
// More than MAX_ROWS = 128 rows: the wrapper launches the step in slices
// of at most 128 rows (ops/kernels/fused_step.py row_slices) that hold
// whole audios or, for a group wider than 128 rows, part of one audio's
// group; each slice is one call of fused_decoder_layers with its first row
// (row0), the tensors' full row count (B_total), its first audio (a0) and
// the tensors' audio count (A_total).  The entry point indexes from those
// four: x, the hidden state, the positions, k_new/v_new (L, B_total, C),
// the self cache and the pending block (L, B_total, ...) start at row row0
// of each layer, the cross K/V and their scales (L, A_total, ...) at audio
// a0, and every layer stride counts B_total rows (A_total audios).  A
// slice's B / A rows share an audio, so a part of a group is a slice of
// one audio (A = 1).  No slice of a cache is copied: a slice's launches
// read and write the full tensors in place.  One slice is the whole step
// at B <= 128 (row0 = a0 = 0, B_total = B, A_total = A).
//
// The pending block (fused_step_pallas.py:312-314, pend_k/pend_v/pend_w;
// models/whisper.decoder_step_pending and decoder_step_fused_pending): the
// write-block engine defers each step's K/V column to a small (L, B, H, D,
// W) buffer of the block's W steps, time last like the cache, and copies it
// into the cache once per block.  With it, row b's self-attention keys are
// its cache positions < t[b] (t is then the block's start), the first
// pend_w pending columns, and the new token.  Only the self-attention
// launch changes (decode_attention_kernel<..., PEND = true>): the blocks
// split the cache keys as before, and rank 0 takes the pending columns
// beside the new token, read straight from device memory (at most 64 of
// them, 16 bytes apart in bf16); the other seven launches of a layer are
// those of the step without a block.  The block adds 2 * L * B *
// H * D * W elements to read, 2.6 MB at B = 16 and W = 8 in bf16, beside
// the 183.5 MB of turbo's decoder weights; on a GPU the cache column is
// written in place either way, so the block saves no device bytes here: it
// lets the engine read its stop flag once per block instead of once per
// step.

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = WARPS;  // one output row per warp
constexpr int MAX_ROWS = 128;          // B at most
constexpr int MAX_PEND = 64;           // a pending block's columns at most
constexpr int TILE_ROWS = 16;          // GEMV input rows per block (a row tile)
// GEMV input rows per block: 47 KB, which leaves room for the kernel's
// static shared memory inside the 48 KB a launch gets without opting in
// (192 KB, fc2's whole input at B = 5, measured no faster)
constexpr int SMEM_FLOATS = 12032;
constexpr int CHUNK_ALIGN = 256;       // 32 lanes x 8 bf16 (or 2 x 4 f32)
// the tensor-core GEMV (bf16, more than one row): a tile's 16 input rows in
// chunks of at most TC_CHUNK bf16 each, rows TC_PAD apart beyond the chunk
// (16 bytes, so that the 8 rows a warp's fragment load touches fall on
// different banks); 16 x 1288 x 2 = 41 KB, inside the 48 KB without opt-in
constexpr int TC_CHUNK = 1280;
constexpr int TC_PAD = 8;
constexpr float LN_EPS = 1e-5f;
// K5's weight stream (mlp_stream_kernel): consumer warps, one tile of a
// group each (six: fc1's 320 tiles over 66 clusters give a block 4 or 5,
// fc2's 80 over the 15 clusters of eight that fit beside fc1 5 or 6); a
// box is 16 weight rows x 128 bytes (the swizzle's span), a stage
// WS_CHUNKS boxes per consumer; ring stages (4 x 24 KB: most of a block's
// ~100 KB of fc1 or fc2 at C = 1280 is asked for before the wait), at least
// 2 where a block would not fit otherwise; tiles a cluster takes at most;
// blocks a cluster at most (a portable cluster); the shared memory a block
// may take, so that two fit an SM (one of the next launch beside it), and
// one that leaves room for only one (to count the clusters that fit beside
// the launch before); fc2's residuals a thread loads beside its share of
// the input rows; a LayerNorm row's 16-byte vectors a lane holds (so C <=
// 32 * 8 * LN_VECS = 2048)
constexpr int WS_CONSUMERS = 6;
constexpr int WS_THREADS = (WS_CONSUMERS + 1) * 32;
constexpr int WS_BOX = TILE_ROWS * 128;
constexpr int WS_CHUNKS = 2;
constexpr int WS_STAGE = WS_CONSUMERS * WS_CHUNKS * WS_BOX;
constexpr int WS_STAGES = 4;
constexpr int WS_MIN_STAGES = 2;
constexpr int WS_MAX_TILES = 8;
constexpr int WS_MAX_SPLIT = 8;
constexpr size_t WS_SMEM_MAX = 113 * 1024;
constexpr size_t WS_ONE_PER_SM = 200 * 1024;
constexpr int RES_REGS = 2;
constexpr int LN_VECS = 8;
// the staged input rows' padding in bf16: 16 bytes (bf16 weights: 4-byte
// B loads, rows 4 banks apart) or 32 (int8: 8-byte loads, 8 banks apart),
// so that a warp's B fragment loads fall on distinct banks
template <typename WT>
struct WsPad {
  static constexpr int N = sizeof(WT) == 1 ? 16 : 8;
};
// decode_attention: keys per tile, the ring's tiles (all of a block's K
// and V tiles at Ta = 1500 over eight blocks are in flight at once), blocks
// per (row, head) at most (a portable cluster), the keys per block its
// split aims at, and the blocks per SM its split fills the card with
constexpr int TK = 64;
constexpr int NSTAGE = 6;
constexpr int MAX_SPLIT = 8;
constexpr int SELF_KEYS = 128;
constexpr int CROSS_KEYS = 192;
constexpr int SPLIT_BLOCKS_PER_SM = 2;

// Up to three weight segments of seg_rows output rows each: output row r
// uses segment r / seg_rows (q|k|v share one launch).  Weights of type WT
// (T, or int8_t with f32 scales s[seg][row]; a null s is none).  A null
// bias is none.  Input row b of output segment s is written at out[s] + b *
// seg_rows, as T (or, for the unrounded f32 epilogue, as float).  With a
// residual, res (laid out as out[0]) holds it; a null res: out[0] itself.
template <typename T, typename WT>
struct Segments {
  const WT* w[3];
  const float* s[3];
  const T* b[3];
  void* out[3];
  const T* res;
};

// a[s], s in [0, 3), by selects: the array stays in the kernel's parameter
// bank, where a dynamic index would copy the segments to local memory
template <typename P>
__device__ __forceinline__ P seg_at(P const (&a)[3], int s) {
  return s == 0 ? a[0] : (s == 1 ? a[1] : a[2]);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// The GEMVs' epilogue for input row b and output row rr of segment s,
// rounding as decoder_step does: y = round(acc * scale) (int8 weights) or
// round(acc); with a bias y = round(y + b); with GELU y = round(gelu(y));
// with RESID y = round(residual + y) is written, the residual read from
// seg.res (or, where that is null, from the output itself, in place).
// F32OUT: acc * scale stored as float, unrounded
// (the int8 logits).
template <typename T, typename WT, bool GELU, bool RESID, bool F32OUT>
__device__ __forceinline__ void epilogue(Segments<T, WT> seg, int s, int rr, size_t b,
                                         int seg_rows, float acc) {
  const float* sc = seg_at(seg.s, s);
  if (sc != nullptr) acc *= sc[rr];
  if constexpr (F32OUT) {
    static_cast<float*>(seg_at(seg.out, s))[b * seg_rows + rr] = acc;
  } else {
    float y = round_to<T>(acc);
    const T* bias = seg_at(seg.b, s);
    if (bias != nullptr) y = round_to<T>(y + to_f(bias[rr]));
    if (GELU) y = round_to<T>(gelu_erf(y));
    T* out = static_cast<T*>(seg_at(seg.out, s)) + b * seg_rows + rr;
    if (RESID) y = round_to<T>(to_f(seg.res != nullptr ? seg.res[b * seg_rows + rr] : *out) + y);
    *out = from_f<T>(y);
  }
}

// The int8 value in byte k (0-3) of a word as a float, exactly, without
// the conversion unit (a quarter of the FMA rate): `biased` is the word ^
// 0x80808080, its bytes x + 128 in [0, 255]; one byte permute puts byte k
// under the exponent of 2^23, and subtracting 2^23 + 128 leaves x.
__device__ __forceinline__ float i8_at(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | k)) - 8388736.f;
}

// acc[b] += W[r, i : i + V] . h[b, i : i + V] for the NB (>= nb) rows held
// in shared memory at hs + b * chunk; one 16-byte load of weights (V = 4
// f32, 8 bf16 or 16 int8 values)
template <typename WT, int NB>
__device__ __forceinline__ void dot_rows(const WT* __restrict__ w, const float* hs, int chunk,
                                         int nb, int i, float* acc) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    // converted four at a time, as each float4 of inputs is consumed, so
    // that the 16 weights do not take 16 registers
    const uint4 u = *reinterpret_cast<const uint4*>(w + i);
    const uint32_t words[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                               u.w ^ 0x80808080u};
#pragma unroll
    for (int u4 = 0; u4 < 4; ++u4) {
      const float w0 = i8_at(words[u4], 0), w1 = i8_at(words[u4], 1);
      const float w2 = i8_at(words[u4], 2), w3 = i8_at(words[u4], 3);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b < nb) {
          const float4 h = reinterpret_cast<const float4*>(hs + b * chunk + i)[u4];
          acc[b] = fmaf(w0, h.x, acc[b]);
          acc[b] = fmaf(w1, h.y, acc[b]);
          acc[b] = fmaf(w2, h.z, acc[b]);
          acc[b] = fmaf(w3, h.w, acc[b]);
        }
      }
    }
  } else {
    constexpr int V = Vec16<WT>::N;
    float wv[V];
    load16(w + i, wv);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float4* h4 = reinterpret_cast<const float4*>(hs + b * chunk + i);
#pragma unroll
        for (int u4 = 0; u4 < V / 4; ++u4) {
          const float4 h = h4[u4];
          acc[b] = fmaf(wv[4 * u4 + 0], h.x, acc[b]);
          acc[b] = fmaf(wv[4 * u4 + 1], h.y, acc[b]);
          acc[b] = fmaf(wv[4 * u4 + 2], h.z, acc[b]);
          acc[b] = fmaf(wv[4 * u4 + 3], h.w, acc[b]);
        }
      }
    }
  }
}

// y[b, r] = epilogue(W[r, :] . h[b, :]) for r < rows and the rows b of this
// block's tile: blockIdx.y * TILE_ROWS + [0, nb), nb <= NB, of the n_rows
// rows; h = x or LayerNorm(x) rowwise.
// Occupancy: one row (NB = 1) keeps to 48 registers (no spill), so that
// five blocks fit on an SM and fc1's 640 blocks still run in one wave (660
// slots), 64 with the residual epilogue (the C-row projections: 160
// blocks);
// more rows get up to 64 (four blocks, as their 48 KB of input rows allow
// anyway), 128 (eight rows) or all they need (sixteen; f32 only).
template <typename T, typename WT, int NB, bool LN, bool GELU, bool RESID, bool F32OUT>
__global__ void __launch_bounds__(THREADS, NB == 1 ? (RESID ? 4 : 5) : (NB <= 5 ? 4 : (NB <= 8 ? 2 : 1)))
gemv_kernel(const T* __restrict__ x, int n_rows, int n_in, int chunk, const T* __restrict__ ln_g,
            const T* __restrict__ ln_b, Segments<T, WT> seg, int seg_rows, int rows) {
  // this block's row tile; only the 16-row instance has more than one, so
  // the others need no tile arithmetic (one row then fits its 32 registers
  // without spilling)
  const int b0 = NB == TILE_ROWS ? blockIdx.y * TILE_ROWS : 0;
  const int nb = NB == TILE_ROWS ? min(TILE_ROWS, n_rows - b0) : n_rows;
  x += (size_t)b0 * n_in;
  extern __shared__ float4 hs4[];
  float* hs = reinterpret_cast<float*>(hs4);  // (nb, chunk)
  __shared__ float red[32];
  __shared__ float mean_s[NB], rstd_s[NB];

  constexpr int V = Vec16<WT>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_BLOCK + warp;
  const bool active = r < rows;
  const int s = active ? r / seg_rows : 0;
  const int rr = r - s * seg_rows;
  const WT* w = active ? seg_at(seg.w, s) + (size_t)rr * n_in : nullptr;
  // the weights are the step's constants: into L2 while the launch before
  // this one finishes (the first row tile's blocks ask for them)
  if (active && lane == 0 && b0 == 0) prefetch_l2(w, (uint32_t)(n_in * sizeof(WT)));
  pdl_wait();
  pdl_trigger();

  // LayerNorm statistics: from the rows in shared memory when the whole
  // input fits in one chunk, else first from device memory
  const bool whole = chunk >= n_in;
  if (LN && !whole) {
    for (int b = 0; b < nb; ++b) {
      const T* xb = x + (size_t)b * n_in;
      float s = 0.f;
      for (int i = threadIdx.x; i < n_in; i += THREADS) s += to_f(xb[i]);
      const float mean = block_sum(s, red) / n_in;
      float s2 = 0.f;
      for (int i = threadIdx.x; i < n_in; i += THREADS) {
        const float d = to_f(xb[i]) - mean;
        s2 += d * d;
      }
      const float rstd = rsqrtf(block_sum(s2, red) / n_in + LN_EPS);
      if (threadIdx.x == 0) {
        mean_s[b] = mean;
        rstd_s[b] = rstd;
      }
    }
  }

  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;

  for (int c0 = 0; c0 < n_in; c0 += chunk) {
    const int len = min(chunk, n_in - c0);
    __syncthreads();  // the previous chunk is consumed; the statistics are visible
    for (int b = 0; b < nb; ++b) {
      const T* xb = x + (size_t)b * n_in + c0;
      for (int i = threadIdx.x; i < len; i += THREADS) {
        float v = to_f(xb[i]);
        if (LN && !whole)
          v = round_to<T>((v - mean_s[b]) * rstd_s[b] * to_f(ln_g[c0 + i]) + to_f(ln_b[c0 + i]));
        hs[b * chunk + i] = v;
      }
    }
    if (LN && whole) {
      __syncthreads();
      for (int b = 0; b < nb; ++b) {
        float* hb = hs + b * chunk;
        float s = 0.f;
        for (int i = threadIdx.x; i < n_in; i += THREADS) s += hb[i];
        const float mean = block_sum(s, red) / n_in;
        float s2 = 0.f;
        for (int i = threadIdx.x; i < n_in; i += THREADS) {
          const float d = hb[i] - mean;
          s2 += d * d;
        }
        const float rstd = rsqrtf(block_sum(s2, red) / n_in + LN_EPS);
        for (int i = threadIdx.x; i < n_in; i += THREADS)
          hb[i] = round_to<T>((hb[i] - mean) * rstd * to_f(ln_g[i]) + to_f(ln_b[i]));
      }
    }
    __syncthreads();
    if (active) {
      // unrolled so that several 16-byte weight loads are in flight
      if constexpr (NB == 1) {
#pragma unroll 4
        for (int i = lane * V; i < len; i += 32 * V) dot_rows<WT, NB>(w + c0, hs, chunk, nb, i, acc);
      } else {
#pragma unroll 2
        for (int i = lane * V; i < len; i += 32 * V) dot_rows<WT, NB>(w + c0, hs, chunk, nb, i, acc);
      }
    }
  }

  if (active) {
    float mine = 0.f;  // lane b keeps row b's sum
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float sum = warp_sum(acc[b]);
        if (lane == b) mine = sum;
      }
    }
    if (lane < nb)
      epilogue<T, WT, GELU, RESID, F32OUT>(seg, s, rr, (size_t)(b0 + lane), seg_rows, mine);
  }
}

// two int8 values (bytes lo and lo + 1 of a biased word, see i8_at) as a
// bf16 pair: an integer of at most 8 bits is exact in f32 with its low 16
// bits zero, so its bf16 is the top half of its f32
__device__ __forceinline__ uint32_t bf16x2_of_i8(uint32_t biased, int lo) {
  return __byte_perm(__float_as_uint(i8_at(biased, lo)), __float_as_uint(i8_at(biased, lo + 1)),
                     0x7632);
}

// eight int8 values as eight bf16, in order (element 0 in the low half of .x)
__device__ __forceinline__ uint4 bf16x8_of_i8x8(uint2 u) {
  const uint32_t x = u.x ^ 0x80808080u, y = u.y ^ 0x80808080u;
  return make_uint4(bf16x2_of_i8(x, 0), bf16x2_of_i8(x, 2), bf16x2_of_i8(y, 0),
                    bf16x2_of_i8(y, 2));
}

// mean and 1 / std of the n values at xb, by one warp: two passes, as
// layer_norm takes them
template <typename T>
__device__ __forceinline__ void warp_ln_stats(const T* xb, int n, float& mean, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += to_f(xb[i]);
  mean = warp_sum(s) / n;
  float s2 = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float d = to_f(xb[i]) - mean;
    s2 += d * d;
  }
  rstd = rsqrtf(warp_sum(s2) / n + LN_EPS);
}

// gemv_kernel's function for bf16 tiles of 16 input rows, on the tensor
// cores: the tile's rows are the M = 16 side of mma.m16n8k16, the block's
// 8 * NT output rows NT tiles of its N = 8, and the block's 8 warps split
// the inputs (K) in slabs of 32, then add their partial sums in warp order.
// A lane loads 8 consecutive weights of each of its NT output rows (16-byte
// loads) and the same 8 inputs of two tile rows from shared memory; the K
// order inside a slab is permuted alike on both sides, which a dot product
// does not see.  Products of bf16 values are exact in f32, as on the CUDA
// cores; only the order of the f32 sums differs.  The tile is loaded with
// 16-byte copies, and each warp takes the LayerNorm statistics of its own
// rows (no block-wide reduction).  Grid: (row tiles, output rows / (8 NT)),
// the tiles of one weight block adjacent, so the later tiles read it from L2.
// int8 weights: a lane loads its 8 weights of a row with one 8-byte load and
// converts them to bf16 in registers (exact), so the same mma runs.  One n
// tile (NT = 1) also takes a segment whose rows are not a multiple of 8 (the
// logits' vocabulary): the last block's rows past it read the segment's last
// row and write nothing.
template <typename WT, int NT, bool LN, bool GELU, bool RESID, bool F32OUT>
__global__ void __launch_bounds__(THREADS, 2)
gemv_tc_kernel(const __nv_bfloat16* __restrict__ x, int n_rows, int n_in, int chunk,
               const __nv_bfloat16* __restrict__ ln_g, const __nv_bfloat16* __restrict__ ln_b,
               Segments<__nv_bfloat16, WT> seg, int seg_rows) {
  using T = __nv_bfloat16;
  constexpr int OUT = 8 * NT;  // output rows per block
  const int b0 = blockIdx.x * TILE_ROWS;
  const int nb = min(TILE_ROWS, n_rows - b0);
  x += (size_t)b0 * n_in;
  const int stride = chunk + TC_PAD;
  extern __shared__ float4 hs4[];
  T* hs = reinterpret_cast<T*>(hs4);  // (TILE_ROWS, stride); then the partial sums
  __shared__ float mean_s[TILE_ROWS], rstd_s[TILE_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the fragments' group and thread in group
  const int r0 = blockIdx.y * OUT;
  const int s = r0 / seg_rows;
  const int rr0 = r0 - s * seg_rows;
  // the block's weight rows into L2 before the wait (gemv_kernel's reason)
  if (blockIdx.x == 0 && threadIdx.x < OUT)
    prefetch_l2(seg_at(seg.w, s) + (size_t)min(rr0 + (int)threadIdx.x, seg_rows - 1) * n_in,
                (uint32_t)(n_in * sizeof(WT)));
  pdl_wait();
  pdl_trigger();

  const bool whole = chunk >= n_in;
  if (LN && !whole) {  // statistics first, from device memory, one row per warp
    for (int b = warp; b < nb; b += WARPS) {
      float mean, rstd;
      warp_ln_stats(x + (size_t)b * n_in, n_in, mean, rstd);
      if (lane == 0) {
        mean_s[b] = mean;
        rstd_s[b] = rstd;
      }
    }
  }

  // n tile j: + 8 j rows (NT = 2 only where seg_rows is a multiple of 16)
  const WT* w = seg_at(seg.w, s) + (size_t)min(rr0 + g, seg_rows - 1) * n_in + tig * 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int c0 = 0; c0 < n_in; c0 += chunk) {
    const int len = min(chunk, n_in - c0);
    const int vecs = len / 8;  // 16-byte vectors per row
    __syncthreads();  // the previous chunk is consumed; the statistics are visible
    for (int v = threadIdx.x; v < TILE_ROWS * vecs; v += THREADS) {
      const int b = v / vecs, i = (v - b * vecs) * 8;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);  // rows past the tile's last stay zero
      if (b < nb) {
        u = *reinterpret_cast<const uint4*>(x + (size_t)b * n_in + c0 + i);
        if (LN && !whole) {
          T* e = reinterpret_cast<T*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = from_f<T>((to_f(e[j]) - mean_s[b]) * rstd_s[b] * to_f(ln_g[c0 + i + j]) +
                             to_f(ln_b[c0 + i + j]));
        }
      }
      *reinterpret_cast<uint4*>(hs + b * stride + i) = u;
    }
    if (LN && whole) {
      __syncthreads();
      for (int b = warp; b < nb; b += WARPS) {
        T* hb = hs + b * stride;
        float mean, rstd;
        warp_ln_stats(hb, n_in, mean, rstd);
        for (int i = lane; i < n_in; i += 32)
          hb[i] = from_f<T>((to_f(hb[i]) - mean) * rstd * to_f(ln_g[i]) + to_f(ln_b[i]));
      }
    }
    __syncthreads();
    const T* h_lo = hs + g * stride + tig * 8;
    const T* h_hi = h_lo + 8 * stride;
#pragma unroll 2
    for (int k = warp * 32; k < len; k += WARPS * 32) {
      uint4 wv[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (std::is_same<WT, int8_t>::value)
          wv[j] = bf16x8_of_i8x8(*reinterpret_cast<const uint2*>(w + (size_t)j * 8 * n_in + c0 + k));
        else
          wv[j] = *reinterpret_cast<const uint4*>(w + (size_t)j * 8 * n_in + c0 + k);
      }
      const uint4 lo = *reinterpret_cast<const uint4*>(h_lo + k);
      const uint4 hi = *reinterpret_cast<const uint4*>(h_hi + k);
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t p0[2] = {wv[j].x, wv[j].y}, p1[2] = {wv[j].z, wv[j].w};
        mma_bf16_m16n8k16(acc[j], a0, p0);
        mma_bf16_m16n8k16(acc[j], a1, p1);
      }
    }
  }

  // C fragments: tile rows g and g + 8, output columns 8 j + 2 tig + {0, 1}
  __syncthreads();  // every warp is done with the tile: its memory takes the sums
  float* part = reinterpret_cast<float*>(hs4) + warp * TILE_ROWS * OUT;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    part[g * OUT + 8 * j + 2 * tig] = acc[j][0];
    part[g * OUT + 8 * j + 2 * tig + 1] = acc[j][1];
    part[(g + 8) * OUT + 8 * j + 2 * tig] = acc[j][2];
    part[(g + 8) * OUT + 8 * j + 2 * tig + 1] = acc[j][3];
  }
  __syncthreads();
  if (threadIdx.x < TILE_ROWS * OUT) {
    const int m = threadIdx.x / OUT, n = threadIdx.x - m * OUT;
    if (m < nb && rr0 + n < seg_rows) {
      const float* all = reinterpret_cast<const float*>(hs4);
      float sum = 0.f;
      for (int v = 0; v < WARPS; ++v) sum += all[(v * TILE_ROWS + m) * OUT + n];
      epilogue<T, WT, GELU, RESID, F32OUT>(seg, s, rr0 + n, (size_t)(b0 + m), seg_rows, sum);
    }
  }
}

// the sum of a 16-byte vector's eight bf16, and of their squared
// deviations from m
__device__ __forceinline__ float sum8(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16x2(w[i]);
    s += f.x + f.y;
  }
  return s;
}

__device__ __forceinline__ float sqdev8(uint4 u, float m) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16x2(w[i]);
    s += (f.x - m) * (f.x - m) + (f.y - m) * (f.y - m);
  }
  return s;
}

// row b0 + b's 16-byte vector at column k of x (rows of n values), or
// zeros where b >= nb or k >= end: a predicated load, whose use the caller
// keeps apart, so that a thread's loads are in flight together (a load and
// its use under one branch wait for the load before them), and no load for
// a row or column past the end (an address that every block asks for at
// once would queue them all at one L2 slice)
__device__ __forceinline__ uint4 row_vec(const __nv_bfloat16* x, int b0, int b, int nb, int n, int k, int end) {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (b < nb && k < end) u = *reinterpret_cast<const uint4*>(x + (size_t)(b0 + b) * n + k);
  return u;
}

// LayerNorm of one row a warp holds, lane l its 16-byte vectors l + 32 i
// (zeros past n): the mean, then the mean square deviation (as layer_norm
// takes them), each over the warp in warp_sum's order; the vectors in
// columns [k0, k1) normalised and rounded into row[k - k0], with the
// weights of column k at g[k - k0] and b[k - k0]
__device__ __forceinline__ void ln_row(const uint4 (&v)[LN_VECS], int n, int k0, int k1,
                                       const __nv_bfloat16* g, const __nv_bfloat16* b, __nv_bfloat16* row) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_VECS; ++i) s += sum8(v[i]);  // zeros past n
  const float mean = warp_sum(s) / n;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < LN_VECS; ++i)
    if (8 * (lane + 32 * i) < n) s2 += sqdev8(v[i], mean);
  const float rstd = rsqrtf(warp_sum(s2) / n + LN_EPS);
#pragma unroll
  for (int i = 0; i < LN_VECS; ++i) {
    const int k = 8 * (lane + 32 * i);
    if (k < k0 || k >= k1) continue;
    const uint4 gv = *reinterpret_cast<const uint4*>(g + k - k0);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + k - k0);
    const uint32_t xw[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w}, bw[4] = {bv.x, bv.y, bv.z, bv.w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = unpack_bf16x2(xw[q]), gf = unpack_bf16x2(gw[q]), bf = unpack_bf16x2(bw[q]);
      o[q] = pack_bf16x2((f.x - mean) * rstd * gf.x + bf.x, (f.y - mean) * rstd * gf.y + bf.y);
    }
    *reinterpret_cast<uint4*>(row + k - k0) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// mlp_stream_kernel's output i of a rank that owns `own` rows of each of
// its cluster's tiles from t0 on, nb input rows: tile i / (own nb), input
// row n, owned row fastest; returns the output row
__device__ __forceinline__ int owned_row(int i, int own, int nb, int t0, int rank, int& n) {
  const int tl = i / (own * nb), e = i - tl * own * nb;
  n = e / own;
  return (t0 + tl) * TILE_ROWS + rank * own + (e - n * own);
}

// acc += the NB (1 or 2) boxes at box (16 weight rows x 128 bytes each,
// swizzled, WS_BOX apart, columns col, col + KC, ... of the staged rows xs)
// times the staged rows: box i's k16 steps into the chains acc[2 i + step
// % 2], so that a warp has four independent chains of mma in flight.
// 16-byte chunk q of a box row r lies where the 128-byte swizzle put it:
// q ^ (r % 8).  int8: ldmatrix moves four int8 a lane as one 32-bit pair;
// lane (g, t) holds bytes 4t .. 4t + 3 of rows g and g + 8 of a chunk,
// converted to bf16 in registers (exactly), as the step's k 2t, 2t + 1 and
// 2t + 8, 2t + 9, and takes the input row's four bf16 there (the same
// permutation on both sides of the dot product).
template <typename WT, int NT, int NB>
__device__ __forceinline__ void mma_boxes(const unsigned char* box, const __nv_bfloat16* xs, int ldx, int col,
                                          float (&acc)[4][NT][4]) {
  using T = __nv_bfloat16;
  constexpr int KC = 128 / (int)sizeof(WT);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, r = lane & 15;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
#pragma unroll
    for (int kk = 0; kk < 8; kk += 2) {
      uint32_t raw[4];
      ldmatrix_x4(raw, box + i * WS_BOX + r * 128 + (((kk + (lane >> 4)) ^ (r & 7)) << 4));
      if constexpr (std::is_same<WT, int8_t>::value) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // chunks kk + h: a k16 step of 16 int8 each
          const uint32_t lo = raw[2 * h] ^ 0x80808080u, hi = raw[2 * h + 1] ^ 0x80808080u;
          const uint32_t a[4] = {bf16x2_of_i8(lo, 0), bf16x2_of_i8(hi, 0), bf16x2_of_i8(lo, 2),
                                 bf16x2_of_i8(hi, 2)};
          const int k = col + i * KC + 16 * (kk + h) + 4 * t;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint2 bv = *reinterpret_cast<const uint2*>(xs + (8 * j + g) * ldx + k);
            const uint32_t bb[2] = {bv.x, bv.y};
            mma_bf16_m16n8k16(acc[2 * i + h][j], a, bb);
          }
        }
      } else {  // chunks kk and kk + 1: a k16 step of 16 bf16
        const int k = col + i * KC + 8 * kk + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const T* hp = xs + (8 * j + g) * ldx + k;
          const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(hp), *reinterpret_cast<const uint32_t*>(hp + 8)};
          mma_bf16_m16n8k16(acc[2 * i + ((kk >> 1) & 1)][j], raw, bb);
        }
      }
    }
  }
}

// K5's products in bf16 (mlp_stream_kernel): y[b, r] = epilogue(W[r, :] .
// h[b, :]) for W (n_out, n_in) of type WT, bf16 or int8 (scales in the
// epilogue), and the rows b of this block's row tile, blockIdx.y * 16 + [0,
// nb), h = x or LayerNorm(x) rowwise, rounded to bf16.
// At one to sixteen rows the product is a stream of weights, each read once
// for every row, so the weights are the M side of mma.m16n8k16 (tiles of 16
// output rows) and the input rows its N side (n8 tiles: NT = 1 up to 8
// rows, 2 up to 16; one row pads to 8), as E2's logits_vc_kernel multiplies.
// The grid is persistent: clusters of `split` blocks, one block per SM (so
// that a block of the next launch fits beside each under programmatic
// dependent launch), cluster q owning a contiguous range of the tiles and
// rank r of it a contiguous range of the inputs, both equal to within one
// (chunks of 128 bytes of weights: 64 bf16 or 128 int8 columns, `per` at
// most): fc2's 80 tiles over eight ranks leave no cluster a second wave.
// A producer warp streams the block's weights through a ring of `stages`
// stages by TMA (boxes of 16 rows x 128 bytes, 128-byte swizzle, zero-filled
// past the tensor's edges); the weights are constants of the step, so it
// starts before pdl_wait() and its stages land while the launch before this
// one drains.  Stage u holds chunks c, c + 1 of a group of up to
// WS_CONSUMERS tiles, and consumer warp w owns tile w of each group: it
// accumulates the tile over the rank's chunks alone, in four chains of mma
// (two boxes, even and odd k16 steps) added at the tile's end, so no two
// warps share a tile.  Before the wait the consumers fetch what is constant
// (the epilogue's scales and biases, fc1's LayerNorm weights); after it
// they stage the rows' slice of the inputs once (fc1: each warp a row pair's
// LayerNorm from registers; fc2: with its residuals) and only then let the
// next launch start, whose weight stream would otherwise queue ahead of
// these reads; then they take their boxes: A fragments from the swizzled
// box by ldmatrix, B fragments from the staged rows.  A finished tile's
// rows go to the ranks that own them (rank r: rows r * 16 / split ...,
// through distributed shared memory), and after one cluster barrier each
// rank adds its rows' parts in rank order (deterministic) and runs the
// epilogue: one rounding of the f32 sum (times the int8 scale), then the
// bias, GELU and residual each rounded, as epilogue() does.
template <typename WT, int NT, bool LN, bool GELU, bool RESID>
__global__ void __launch_bounds__(WS_THREADS, 2)
mlp_stream_kernel(const __grid_constant__ CUtensorMap tw, const __nv_bfloat16* __restrict__ x, int n_rows,
                  int n_in, int n_out, const __nv_bfloat16* __restrict__ ln_g,
                  const __nv_bfloat16* __restrict__ ln_b, Segments<__nv_bfloat16, WT> seg, int per,
                  int stages) {
  using T = __nv_bfloat16;
  static_assert(!(LN && RESID), "fc1 normalises its input, fc2 adds the residual");
  constexpr int NC = WS_CONSUMERS;
  constexpr int KC = 128 / (int)sizeof(WT);  // weight columns per box
  constexpr int OUT = 8 * NT;                // input rows of a tile, padded
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int clusters = (int)gridDim.x / split, cq = (int)blockIdx.x / split;
  const int n_tiles = (n_out + TILE_ROWS - 1) / TILE_ROWS;
  const int tq = n_tiles / clusters, trem = n_tiles % clusters, tmax = tq + (trem > 0);
  const int t0 = cq * tq + min(cq, trem), n_tl = tq + (cq < trem ? 1 : 0);
  const int chunks = (n_in + KC - 1) / KC, cn = chunks / split, crem = chunks % split;
  const int c0 = rank * cn + min(rank, crem), nkc = cn + (rank < crem ? 1 : 0);
  const int spg = (nkc + WS_CHUNKS - 1) / WS_CHUNKS;  // stages per group of tiles
  const int n_stages = (n_tl + NC - 1) / NC * spg;
  const int k0 = c0 * KC, k1 = min(n_in, k0 + nkc * KC), kw = per * KC, ldx = kw + WsPad<WT>::N;
  const int own = TILE_ROWS / split;  // output rows of a tile each rank finishes
  const int b0 = blockIdx.y * TILE_ROWS, nb = min(TILE_ROWS, n_rows - b0);
  const int n_fin = n_tl * own * nb;  // this rank's outputs
  // shared memory: the ring (1024-byte aligned, the swizzle's period), the
  // parts of the tiles' rows this rank owns (tiles, split, own, OUT), the
  // epilogue's scale, bias and residual per output, the staged rows (OUT,
  // ldx), the LayerNorm weights of the rank's columns, the barriers
  unsigned char* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* recv = reinterpret_cast<float*>(ring + stages * WS_STAGE);
  float* ep = recv + tmax * TILE_ROWS * OUT;  // (3, tmax * 16 * OUT / split)
  const int ep_n = tmax * own * OUT;
  T* xs = reinterpret_cast<T*>(ep + 3 * ep_n);
  T* lns = xs + OUT * ldx;  // (2, kw): the LayerNorm weights of the rank's columns, LN only
  uint64_t* full = reinterpret_cast<uint64_t*>(lns + (LN ? 2 * kw : 0));
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NC);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // every block of the cluster has started before any writes into another's
  // shared memory: this arrival, and the wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");

  if (warp == NC) {  // the producer: every stage of the block, before the wait
    if (lane == 0) {
      for (int u = 0; u < n_stages; ++u) {
        const int s = u % stages, gi = u / spg, c = (u - gi * spg) * WS_CHUNKS;
        const int tiles = min(NC, n_tl - gi * NC), nch = min(WS_CHUNKS, nkc - c);
        hopper::mbar_wait(&empty[s], ((u / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], tiles * nch * WS_BOX);
        for (int w = 0; w < tiles; ++w)
          for (int i = 0; i < nch; ++i)
            hopper::tma_load_2d(ring + s * WS_STAGE + (w * WS_CHUNKS + i) * WS_BOX, &tw, &full[s],
                                (c0 + c + i) * KC, (t0 + gi * NC + w) * TILE_ROWS);
      }
    }
    __syncwarp();  // the warp meets the cluster barriers converged
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
  } else {
    const int ct = threadIdx.x;  // 0 .. NC * 32
    // Output i of this rank: tile i / (own nb), input row n, owned row m
    // (fastest); before the wait its scale and bias (constants), after it
    // the residual.
#pragma unroll 4
    for (int i = ct; i < n_fin; i += NC * 32) {
      int n;
      const int rr = min(owned_row(i, own, nb, t0, rank, n), n_out - 1);
      ep[i] = seg.s[0] != nullptr ? seg.s[0][rr] : 1.f;
      ep[ep_n + i] = seg.b[0] != nullptr ? to_f(seg.b[0][rr]) : 0.f;
    }
    if (LN) {  // the rank's LayerNorm weights, constants: before the wait
      for (int v = ct; v < kw / 8; v += NC * 32) {
        *reinterpret_cast<uint4*>(lns + 8 * v) = row_vec(ln_g, 0, 0, 1, 0, k0 + 8 * v, k1);
        *reinterpret_cast<uint4*>(lns + kw + 8 * v) = row_vec(ln_b, 0, 0, 1, 0, k0 + 8 * v, k1);
      }
    }
    pdl_wait();  // x (and the residual) are the launches before's
    // rows [0, OUT) of the tile, columns [k0, k0 + kw): x (LayerNorm-ed and
    // rounded for fc1) inside [k0, k1) of the rows < nb, zeros elsewhere
    if (LN) {
      // warp w takes rows w and w + NC together (then w + 2 NC, ...), each
      // lane the row's 16-byte vectors lane + 32 i, i < LN_VECS, held in
      // registers from one round trip: the mean, then the mean square
      // deviation, over the whole row (as layer_norm takes them), then the
      // vectors in the rank's columns normalised into the staged rows
      const int vecs = kw / 8;
      for (int v = ct; v < OUT * vecs; v += NC * 32) {  // zeros past nb and past k1
        const int b = v / vecs, k = k0 + 8 * (v - b * vecs);
        if (b >= nb || k >= k1) *reinterpret_cast<uint4*>(xs + b * ldx + k - k0) = make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 32) : "memory");  // the LayerNorm weights are in
#pragma unroll 1
      for (int b = warp; b < nb; b += 2 * NC) {
        uint4 r0[LN_VECS], r1[LN_VECS];
#pragma unroll
        for (int i = 0; i < LN_VECS; ++i) {
          r0[i] = row_vec(x, b0, b, nb, n_in, 8 * (lane + 32 * i), n_in);
          r1[i] = row_vec(x, b0, b + NC, nb, n_in, 8 * (lane + 32 * i), n_in);
        }
        ln_row(r0, n_in, k0, k1, lns, lns + kw, xs + b * ldx);
        if (b + NC < nb) ln_row(r1, n_in, k0, k1, lns, lns + kw, xs + (b + NC) * ldx);
      }
    } else {
      // the residual of the rank's first outputs loaded beside x (one round
      // trip), the rest after
      const T* res = seg.res != nullptr ? seg.res : static_cast<const T*>(seg.out[0]);
      float rv[RES_REGS];
#pragma unroll
      for (int r = 0; r < RES_REGS; ++r) {
        const int i = ct + NC * 32 * r;
        int n = 0;
        const int rr = i < n_fin ? owned_row(i, own, nb, t0, rank, n) : n_out;
        rv[r] = RESID && rr < n_out ? to_f(res[(size_t)(b0 + n) * n_out + rr]) : 0.f;
      }
      const int vecs = kw / 8;
#pragma unroll 4
      for (int v = ct; v < OUT * vecs; v += NC * 32) {
        const int b = v / vecs, k = k0 + 8 * (v - b * vecs);
        *reinterpret_cast<uint4*>(xs + b * ldx + k - k0) = row_vec(x, b0, b, nb, n_in, k, k1);
      }
      if (RESID) {
#pragma unroll
        for (int r = 0; r < RES_REGS; ++r)
          if (ct + NC * 32 * r < n_fin) ep[2 * ep_n + ct + NC * 32 * r] = rv[r];
        for (int i = ct + NC * 32 * RES_REGS; i < n_fin; i += NC * 32) {
          int n;
          const int rr = min(owned_row(i, own, nb, t0, rank, n), n_out - 1);
          ep[2 * ep_n + i] = to_f(res[(size_t)(b0 + n) * n_out + rr]);
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 32) : "memory");  // the rows are staged
    // the next launch may start now: its weights then stream beside this
    // launch's, not ahead of the reads of x above
    pdl_trigger();
    asm volatile("barrier.cluster.wait;\n" ::: "memory");

    const int g = lane >> 2, t = lane & 3;
    float acc[4][NT][4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
    for (int u = 0; u < n_stages; ++u) {
      const int s = u % stages, gi = u / spg, c = (u - gi * spg) * WS_CHUNKS;
      const bool mine = gi * NC + warp < n_tl;
      hopper::mbar_wait(&full[s], (u / stages) & 1);
      if (mine) {
        const unsigned char* box = ring + s * WS_STAGE + warp * WS_CHUNKS * WS_BOX;
        if (nkc - c >= 2) mma_boxes<WT, NT, 2>(box, xs, ldx, c * KC, acc);
        else mma_boxes<WT, NT, 1>(box, xs, ldx, c * KC, acc);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      if (mine && c + WS_CHUNKS >= nkc) {  // the tile is done: its rows to their owners
        const int tl = gi * NC + warp;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8
            const int m = g + 8 * hh;
            const float2 v = make_float2(
                (acc[0][j][2 * hh] + acc[1][j][2 * hh]) + (acc[2][j][2 * hh] + acc[3][j][2 * hh]),
                (acc[0][j][2 * hh + 1] + acc[1][j][2 * hh + 1]) + (acc[2][j][2 * hh + 1] + acc[3][j][2 * hh + 1]));
            float* dst = recv + ((tl * split + rank) * own + m % own) * OUT + 8 * j + 2 * t;
            *reinterpret_cast<float2*>(cluster.map_shared_rank(dst, m / own)) = v;
          }
        }
#pragma unroll
        for (int h = 0; h < 4; ++h)
#pragma unroll
          for (int j = 0; j < NT; ++j) acc[h][j][0] = acc[h][j][1] = acc[h][j][2] = acc[h][j][3] = 0.f;
      }
    }
  }

  cluster.sync();  // every rank's parts are in their owners' shared memory
  if (warp == NC) return;
  for (int i = threadIdx.x; i < n_fin; i += NC * 32) {
    const int tl = i / (own * nb), e = i - tl * own * nb, n = e / own, m = e - n * own;
    const int rr = (t0 + tl) * TILE_ROWS + rank * own + m;
    if (rr >= n_out) continue;
    const float* p = recv + (tl * split * own + m) * OUT + n;
    float sum = 0.f;
    for (int rk = 0; rk < split; ++rk) sum += p[rk * own * OUT];
    float y = round_to<T>(sum * ep[i]);
    if (seg.b[0] != nullptr) y = round_to<T>(y + ep[ep_n + i]);
    if (GELU) y = round_to<T>(gelu_erf(y));
    if (RESID) y = round_to<T>(ep[2 * ep_n + i] + y);
    static_cast<T*>(seg.out[0])[(size_t)(b0 + n) * n_out + rr] = from_f<T>(y);
  }
}

// Block-wide max (or sum) of NQ values at once: one shuffle tree per value,
// then one exchange through `red` (at least WARPS * NQ floats).  Every
// thread gets the NQ results in v.
template <int NQ, bool MAX>
__device__ __forceinline__ void block_reduce_n(float* v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NQ; ++j) v[j] = MAX ? warp_max(v[j]) : warp_sum(v[j]);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) red[warp * NQ + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    float r = MAX ? -INFINITY : 0.f;
    for (int w = 0; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w * NQ + j]) : r + red[w * NQ + j];
    v[j] = r;
  }
}

// decode_attention's arguments.  NQ queries (1, D) per head against
// keys/values stored time-last, (H, D, t_cap) per row or audio, with the
// first n positions valid, plus (self-attention) the new token's own
// key/value and, with a pending block, its first pend_w columns.  n is
// n_max, or with `lens` (self-attention: the rows' positions in device
// memory) lens[row] clamped to [0, n_max].  Query group g takes the rows g
// * NQ + j, j < NQ (row stride C; output likewise) and reads the K/V of
// rows_per_kv consecutive rows at k + (g * NQ / rows_per_kv) * kv_stride
// (NQ divides rows_per_kv).  split blocks (a cluster) share a (group,
// head); each score chunk of chunk_max keys fits the scores' shared memory.
template <typename T, typename KT>
struct Attn {
  const T* q;
  const KT* k;
  const KT* v;
  const T* k_new;  // (B, C) each, or null (cross-attention)
  const T* v_new;
  T* out;
  int n_head, C;
  size_t kv_stride;
  int rows_per_kv;
  const int* lens;
  int n_max, t_cap;
  float scale;
  const float* k_scale;  // int8 K/V: (audios, H, D) each
  const float* v_scale;
  const T* pend_k;  // (B, H, D, pend_W) each, or null
  const T* pend_v;
  int pend_W, pend_w;
  int split, chunk_max;
};

// One K or V tile in shared memory: HD rows of TK keys of type KT, each row
// CHUNKS 16-byte copies (one more than the keys need, for a row that
// starts inside a chunk), ROW bytes apart
template <typename KT>
struct Tile {
  static constexpr int CHUNKS = TK * (int)sizeof(KT) / 16 + 1;
  static constexpr int ROW = CHUNKS * 16;
  static constexpr int BYTES = HD * ROW;
};

// A thread's share of a tile's copies: chunk c = threadIdx.x + THREADS s
// of the HD x CHUNKS, row d = c / CHUNKS, 16-byte chunk i = c % CHUNKS.
// Its source for the block's key t0 is the 16-byte boundary at or before
// row d's key t0, plus 16 i (a row of an odd-length cache starts inside a
// chunk; t0 is a multiple of TK, whose bytes are a multiple of 16, so the
// boundary moves with the tile by TK keys); every byte of a key at or past
// the block's end t1 is zero-filled (never read), so a row's tail reads
// nothing of the next row, head or audio.  Row d's key t0 lands off(d)
// bytes into its tile row.  V's rows lie where K's do, dv bytes on.
template <typename KT>
struct Copies {
  static constexpr int SLOTS = (HD * Tile<KT>::CHUNKS + THREADS - 1) / THREADS;
  uintptr_t src[SLOTS], stop[SLOTS];
  int dst[SLOTS];  // -1: no chunk
  ptrdiff_t dv;

  __device__ __forceinline__ Copies(const KT* kh, const KT* vh, size_t ld, int t0, int t1) {
    using G = Tile<KT>;
    dv = reinterpret_cast<const char*>(vh) - reinterpret_cast<const char*>(kh);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int c = threadIdx.x + THREADS * s;
      const int d = c / G::CHUNKS, i = c - d * G::CHUNKS;
      const KT* row = kh + (size_t)min(d, HD - 1) * ld;
      src[s] = (reinterpret_cast<uintptr_t>(row + t0) & ~uintptr_t(15)) + 16 * (uintptr_t)i;
      stop[s] = reinterpret_cast<uintptr_t>(row + t1);
      dst[s] = c < HD * G::CHUNKS ? d * G::ROW + 16 * i : -1;
    }
  }

  // K (or V) tile j of the block's keys into dst
  __device__ __forceinline__ void load(unsigned char* tile, int j, bool value) const {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if (dst[s] < 0) continue;
      const uintptr_t from = src[s] + (uintptr_t)j * TK * sizeof(KT);
      const int bytes = from >= stop[s] ? 0 : (stop[s] - from >= 16 ? 16 : (int)(stop[s] - from));
      const uintptr_t at = bytes ? from : stop[s] & ~uintptr_t(15);  // a valid address where nothing is read
      cp_async16_n(tile + dst[s], reinterpret_cast<const void*>(at + (value ? dv : 0)), bytes);
    }
  }
};

// the byte at which a row's keys start inside its tile rows
template <typename KT>
__device__ __forceinline__ int row_offset(const KT* row) {
  return (int)(reinterpret_cast<uintptr_t>(row) & 15);
}

// tile i of a block's stream into its stage of the ring: K tiles 0 ..
// tiles - 1, then the V tiles; one commit group per tile (empty past the end)
template <typename KT>
__device__ __forceinline__ void issue_tile(unsigned char* ring, int i, int tiles, const Copies<KT>& cp) {
  if (i < 2 * tiles) cp.load(ring + (i % NSTAGE) * Tile<KT>::BYTES, i < tiles ? i : i - tiles, i >= tiles);
  cp_async_commit();
}

// two neighbouring keys of a tile row as floats
__device__ __forceinline__ float2 load2(const unsigned char* p, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const unsigned char* p, float) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const unsigned char* p, int8_t) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2((float)c.x, (float)c.y);
}

// both values times s, each rounded to T (one packed conversion in bf16)
template <typename T>
__device__ __forceinline__ float2 scale_round2(float2 v, float s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat1622float2(__float22bfloat162_rn(make_float2(v.x * s, v.y * s)));
  else
    return make_float2(v.x * s, v.y * s);
}

// As qkv_attention_kt / decoder_step: q * D^-0.25 and k * D^-0.25 each
// rounded to T, f32 scores, an f32 softmax over the row's keys, weights
// normalised and rounded to T before PV, f32 PV, output rounded to T.
// Block `rank` of the (group, head)'s split takes keys [rank * chunk, ...)
// of its n, chunk = ceil(n / split) rounded up to whole tiles; it streams
// its K tiles, then its V tiles, through the NSTAGE-deep ring (the cache is
// read-only within a step, so the first tiles are asked for before
// pdl_wait()), one barrier per tile.  Scores: the eight lanes 8 kp + e of
// a warp take the keys 2 kp and 2 kp + 1, lane e the rows d = 8 i + e (8 of
// the 64 products of each), the eighths added by a shuffle tree ((e0 + e1)
// + (e2 + e3)) + ((e4 + e5) + (e6 + e7)).  PV: warp w owns rows d = w +
// WARPS i, lane l the tile's keys 2 l and 2 l + 1.
// int8 K/V (KT = int8_t, cross-attention): the scales of the group's audio,
// k_scale/v_scale + (audio * n_head + h) * HD, as the plain version's int8
// branch: the query is round(q * scale * k_scale[d]) with scale = D^-0.5,
// the keys enter unscaled, and the output is round(PV * v_scale[d]).
// Rank 0 of self-attention also scores the pending columns (PEND) and the
// new token from device memory, which enter its max, its sum and its PV.
template <typename T, typename KT, int NQ, bool PEND = false>
__global__ void __launch_bounds__(THREADS, 1) decode_attention_kernel(const Attn<T, KT> a) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  static_assert(!PEND || (NQ == 1 && std::is_same<KT, T>::value),
                "a pending block is self-attention's: one query, keys of the compute dtype");
  static_assert(THREADS == 4 * TK, "eight lanes score each pair of keys of a tile");
  using G = Tile<KT>;
  extern __shared__ float4 smem4[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);   // NSTAGE tiles
  float* sc = reinterpret_cast<float*>(ring + NSTAGE * G::BYTES);  // (NQ, chunk_max) scores, weights
  // the queries d-major, NQ padded to whole float4s: one vector load gives
  // a row d of four queries
  constexpr int QP = NQ == 1 ? 1 : (NQ + 3) / 4 * 4;
  __shared__ __align__(16) float qs[HD][QP];
  __shared__ float bred[WARPS * NQ];
  __shared__ float stat[2][NQ];    // this block's max, and its sum of exp(s - max)
  __shared__ float part[NQ][HD];   // this block's share of each output
  __shared__ float ex[MAX_PEND + 1];  // rank 0, self: pending and new-token scores, then weights
  // where row d's keys start in its tile rows; V's rows lie 16-byte
  // multiples from K's (both caches 16-byte aligned, the same layout)
  __shared__ int koff[HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = a.split;
  const int rank = (int)cluster.block_rank();
  const int gh = blockIdx.x / split;
  const int g = gh / a.n_head, h = gh - g * a.n_head;
  const size_t row0 = (size_t)g * NQ;
  const int n = a.lens != nullptr ? min(max(a.lens[row0], 0), a.n_max) : a.n_max;
  const int chunk = ((n + split - 1) / split + TK - 1) / TK * TK;
  const int t0 = min(n, rank * chunk), t1 = min(n, t0 + chunk), nk = t1 - t0;
  const int tiles = (nk + TK - 1) / TK;
  const size_t audio = row0 / a.rows_per_kv;
  const size_t kv = audio * a.kv_stride + (size_t)h * HD * a.t_cap;
  const KT* kh = a.k + kv;
  const KT* vh = a.v + kv;

  const Copies<KT> cp(kh, vh, a.t_cap, t0, t1);
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue_tile<KT>(ring, i, tiles, cp);
  if (threadIdx.x < HD) koff[threadIdx.x] = row_offset(kh + (size_t)threadIdx.x * a.t_cap);
  pdl_wait();  // q, and the new token's K/V, are the launch before's
  pdl_trigger();

  const float* ks = Q8 ? a.k_scale + (audio * a.n_head + h) * HD : nullptr;
  for (int i = threadIdx.x; i < NQ * HD; i += THREADS) {
    const int j = i / HD, d = i - j * HD;
    const float qf = to_f(a.q[(row0 + j) * a.C + h * HD + d]) * a.scale;
    qs[d][j] = round_to<T>(Q8 ? qf * ks[d] : qf);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rank 0 of self-attention: the pending columns, then the new token
  const bool extras = a.k_new != nullptr && rank == 0;
  const int n_ex = extras ? (PEND ? a.pend_w : 0) + 1 : 0;
  const size_t pend = (row0 * a.n_head + h) * (size_t)HD * a.pend_W;
  const T* kn = a.k_new != nullptr ? a.k_new + row0 * a.C + h * HD : nullptr;
  const T* vn = a.v_new != nullptr ? a.v_new + row0 * a.C + h * HD : nullptr;
  for (int e = warp; e < n_ex; e += WARPS) {
    const T* ke = kn;
    int ld = 1;
    if constexpr (PEND) {
      if (e < n_ex - 1) ke = a.pend_k + pend + e, ld = a.pend_W;
    }
    float s = 0.f;
    for (int d = lane; d < HD; d += 32) s = fmaf(qs[d][0], round_to<T>(to_f(ke[d * ld]) * a.scale), s);
    s = warp_sum(s);
    if (lane == 0) ex[e] = s;
  }
  __syncthreads();  // ex[] is in (a block with no cache keys passes no other barrier first)

  // scores of the K tiles
  const int kp = threadIdx.x >> 3, e8 = threadIdx.x & 7;
  int krow[HD / 8];  // this thread's rows d = 8 i + e8: their byte offsets in a tile
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) krow[i] = (8 * i + e8) * G::ROW + koff[8 * i + e8] + 2 * kp * (int)sizeof(KT);
  float m[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) m[j] = -INFINITY;
  for (int i = 0; i < tiles; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile i is in for every thread; tile i - 1 is consumed
    issue_tile<KT>(ring, i + NSTAGE - 1, tiles, cp);
    const unsigned char* tile = ring + (i % NSTAGE) * G::BYTES;
    float s0[NQ], s1[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) s0[j] = s1[j] = 0.f;
#pragma unroll
    for (int dd = 0; dd < HD / 8; ++dd) {
      const int d = 8 * dd + e8;
      float2 kf = load2(tile + krow[dd], KT());
      if constexpr (!Q8) kf = scale_round2<T>(kf, a.scale);
      if constexpr (NQ == 1) {
        s0[0] = fmaf(qs[d][0], kf.x, s0[0]);
        s1[0] = fmaf(qs[d][0], kf.y, s1[0]);
      } else {
#pragma unroll
        for (int j4 = 0; j4 < QP; j4 += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(&qs[d][j4]);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j4 + e < NQ) {
              s0[j4 + e] = fmaf(qv[e], kf.x, s0[j4 + e]);
              s1[j4 + e] = fmaf(qv[e], kf.y, s1[j4 + e]);
            }
          }
        }
      }
    }
    const int idx = i * TK + 2 * kp;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        s0[j] += __shfl_xor_sync(0xffffffffu, s0[j], o);
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], o);
      }
      if (e8 == 0) {
        if (idx < nk) {
          sc[j * a.chunk_max + idx] = s0[j];
          m[j] = fmaxf(m[j], s0[j]);
        }
        if (idx + 1 < nk) {
          sc[j * a.chunk_max + idx + 1] = s1[j];
          m[j] = fmaxf(m[j], s1[j]);
        }
      }
    }
  }
  if (extras && threadIdx.x == 0) {
    for (int e = 0; e < n_ex; ++e) m[0] = fmaxf(m[0], ex[e]);
  }
  block_reduce_n<NQ, true>(m, bred);
  float l[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) l[j] = 0.f;
  for (int idx = threadIdx.x; idx < nk; idx += THREADS) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) l[j] += expf(sc[j * a.chunk_max + idx] - m[j]);
  }
  if (extras && threadIdx.x == 0) {
    for (int e = 0; e < n_ex; ++e) l[0] += expf(ex[e] - m[0]);
  }
  block_reduce_n<NQ, false>(l, bred);
  if (threadIdx.x == 0) {  // static indices keep m[] and l[] in registers
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      stat[0][j] = m[j];
      stat[1][j] = l[j];
    }
  }
  cluster.sync();  // 1: every block's max and sum are out (its V tiles in flight)

  // the exact maximum and denominator, in rank order
  float mx[NQ], denom[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    mx[j] = -INFINITY;
    for (int rk = 0; rk < split; ++rk) mx[j] = fmaxf(mx[j], *cluster.map_shared_rank(&stat[0][j], rk));
    denom[j] = 0.f;
    for (int rk = 0; rk < split; ++rk) {
      const float mr = *cluster.map_shared_rank(&stat[0][j], rk);
      if (mr != -INFINITY) denom[j] += *cluster.map_shared_rank(&stat[1][j], rk) * expf(mr - mx[j]);
    }
  }
  for (int idx = threadIdx.x; idx < nk; idx += THREADS) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float* p = sc + j * a.chunk_max + idx;
      *p = round_to<T>(expf(*p - mx[j]) / denom[j]);
    }
  }
  if (threadIdx.x < n_ex) ex[threadIdx.x] = round_to<T>(expf(ex[threadIdx.x] - mx[0]) / denom[0]);

  // PV over the V tiles
  constexpr int ROWS = HD / WARPS;
  int vrow[ROWS];  // this warp's rows d = warp + WARPS r: their byte offsets in a tile
#pragma unroll
  for (int r = 0; r < ROWS; ++r) vrow[r] = (warp + WARPS * r) * G::ROW + koff[warp + WARPS * r] + 2 * lane * (int)sizeof(KT);
  float acc[ROWS][NQ];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < NQ; ++j) acc[r][j] = 0.f;
  for (int i = tiles; i < 2 * tiles; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile i is in (and, the first time, every weight); tile i - 1 is consumed
    issue_tile<KT>(ring, i + NSTAGE - 1, tiles, cp);
    const unsigned char* tile = ring + (i % NSTAGE) * G::BYTES;
    const int idx = (i - tiles) * TK + 2 * lane;
    if (idx < nk) {
      // a key past the block's end has weight 0 (its value bytes are zero)
      float w0[NQ], w1[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        w0[j] = sc[j * a.chunk_max + idx];
        w1[j] = idx + 1 < nk ? sc[j * a.chunk_max + idx + 1] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float2 vv = load2(tile + vrow[r], KT());
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[r][j] = fmaf(w1[j], vv.y, fmaf(w0[j], vv.x, acc[r][j]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float s = warp_sum(acc[r][j]);
      if (lane == 0) part[j][warp + WARPS * r] = s;
    }
  }
  cluster.sync();  // 2: every block's part[] is out
  if (rank == 0) {
    for (int i = threadIdx.x; i < NQ * HD; i += THREADS) {
      const int j = i / HD, d = i - j * HD;
      float o = 0.f;
      for (int rk = 0; rk < split; ++rk) o += *cluster.map_shared_rank(&part[j][d], rk);
      for (int e = 0; e < n_ex; ++e) {  // j == 0 here
        const T* ve = vn + d;
        if constexpr (PEND) {
          if (e < n_ex - 1) ve = a.pend_v + pend + (size_t)d * a.pend_W + e;
        }
        o = fmaf(ex[e], to_f(*ve), o);
      }
      if (Q8) o *= a.v_scale[(audio * a.n_head + h) * HD + d];
      a.out[(row0 + j) * a.C + h * HD + d] = from_f<T>(o);
    }
  }
  cluster.sync();  // 3: rank 0 has read every block's part[] before any exits
}

// the card's SM count (the port drives one card)
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return sms;
  }();
  return n;
}

// decode_attention's launch: split blocks per (group, head), a cluster,
// each taking at most chunk_max keys.  The split follows the keys (one
// block per keys_per_block of the largest key count) as far as the
// launch's (group, head) units leave the card room: 20 units of one row
// take up to eight blocks each, 320 units of sixteen rows one.  The
// dynamic shared memory: the ring and the score chunk.
template <typename T, typename KT, int NQ, bool PEND = false>
void attention_launch(Chain& chain, int groups, Attn<T, KT> a, int keys_per_block) {
  const int n = a.n_max;
  const int room = SPLIT_BLOCKS_PER_SM * sm_count() / (groups * a.n_head);
  a.split = min(MAX_SPLIT, max(1, min(room, (n + keys_per_block - 1) / keys_per_block)));
  a.chunk_max = max(TK, ((n + a.split - 1) / a.split + TK - 1) / TK * TK);
  const size_t smem = (size_t)NSTAGE * Tile<KT>::BYTES + (size_t)NQ * a.chunk_max * sizeof(float);
  chain.launch(decode_attention_kernel<T, KT, NQ, PEND>, dim3(groups * a.n_head * a.split), THREADS, smem,
               a.split, a);
}

// weight table order: stacked (L, ...) tensors, torch (out, in) layout;
// the same order as whisper_tpu_torch/ops/kernels/fused_step.py WEIGHTS.
// With int8 weights the eight projections are int8 and their f32 scales,
// (L, out) each, come in a second table in the order of PROJ.
enum W {
  ATTN_LN_G, ATTN_LN_B, Q_W, Q_B, K_W, V_W, V_B, O_W, O_B,
  XATTN_LN_G, XATTN_LN_B, XQ_W, XQ_B, XO_W, XO_B,
  MLP_LN_G, MLP_LN_B, FC1_W, FC1_B, FC2_W, FC2_B, N_WEIGHTS
};
enum PROJ { P_Q, P_K, P_V, P_O, P_XQ, P_XO, P_FC1, P_FC2, N_PROJ };

template <typename T, typename WT, int NB, bool LN, bool GELU, bool RESID, bool F32OUT>
void gemv_launch(Chain& chain, const T* x, int n_rows, int n_in, const T* g, const T* b,
                 Segments<T, WT> seg, int seg_rows, int rows) {
  // a tile's input rows in chunks of at most SMEM_FLOATS floats in all
  const int nb = min(n_rows, TILE_ROWS);
  const int whole = (n_in + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN;
  const int chunk = min(whole, SMEM_FLOATS / nb / CHUNK_ALIGN * CHUNK_ALIGN);
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                  (n_rows + TILE_ROWS - 1) / TILE_ROWS);
  chain.launch(gemv_kernel<T, WT, NB, LN, GELU, RESID, F32OUT>, grid, THREADS,
               (size_t)nb * chunk * sizeof(float), 0, x, n_rows, n_in, chunk, g, b, seg, seg_rows, rows);
}

// the tensor-core GEMV over row tiles of 16: two n tiles per block where
// that still leaves 200 or more blocks (q|k|v and fc1 at C = 1280: 240 and
// 320), else one (the C-row projections: 160 blocks at C = 1280)
template <typename WT, bool LN, bool GELU, bool RESID, bool F32OUT>
void gemv_tc_launch(Chain& chain, const __nv_bfloat16* x, int n_rows, int n_in, const __nv_bfloat16* g,
                    const __nv_bfloat16* b, Segments<__nv_bfloat16, WT> seg, int seg_rows, int rows) {
  const int chunk = min((n_in + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN, TC_CHUNK);
  const size_t smem = (size_t)TILE_ROWS * (chunk + TC_PAD) * sizeof(__nv_bfloat16);
  const int tiles = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  if (seg_rows % 16 == 0 && rows / 16 >= 200)
    chain.launch(gemv_tc_kernel<WT, 2, LN, GELU, RESID, F32OUT>, dim3(tiles, rows / 16), THREADS, smem, 0,
                 x, n_rows, n_in, chunk, g, b, seg, seg_rows);
  else
    chain.launch(gemv_tc_kernel<WT, 1, LN, GELU, RESID, F32OUT>, dim3(tiles, (rows + 7) / 8), THREADS, smem,
                 0, x, n_rows, n_in, chunk, g, b, seg, seg_rows);
}

// the kernel for nb rows: in bf16 the CUDA-core instance for one row and
// the tensor-core GEMV above it; in f32 the CUDA-core instance for the
// smallest of 1, 2, 4, 5, 8, 16 >= nb (more than 16 rows as row tiles of 16)
template <typename T, typename WT, bool LN, bool GELU, bool RESID, bool F32OUT = false>
void gemv(Chain& chain, const T* x, int nb, int n_in, const T* g, const T* b, Segments<T, WT> seg,
          int seg_rows, int rows) {
#define GEMV(NB) \
  gemv_launch<T, WT, NB, LN, GELU, RESID, F32OUT>(chain, x, nb, n_in, g, b, seg, seg_rows, rows)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (nb <= 1) GEMV(1);
    else gemv_tc_launch<WT, LN, GELU, RESID, F32OUT>(chain, x, nb, n_in, g, b, seg, seg_rows, rows);
  } else {
    if (nb <= 1) GEMV(1);
    else if (nb <= 2) GEMV(2);
    else if (nb <= 4) GEMV(4);
    else if (nb <= 5) GEMV(5);
    else if (nb <= 8) GEMV(8);
    else GEMV(16);
  }
#undef GEMV
}

// mlp_stream_kernel's dynamic shared memory: the ring (and its alignment),
// the parts of the owned rows of tmax tiles, the epilogue's values per
// output, OUT staged rows of `per` chunks, fc1's LayerNorm weights, the
// barriers
template <typename WT, bool LN>
size_t stream_smem(int nt, int tmax, int split, int per, int stages) {
  const int out = 8 * nt, kw = per * (128 / (int)sizeof(WT));
  return 1024 + (size_t)stages * WS_STAGE + (size_t)tmax * TILE_ROWS * out * sizeof(float) +
         (size_t)3 * tmax * (TILE_ROWS / split) * out * sizeof(float) +
         (size_t)out * (kw + WsPad<WT>::N) * sizeof(__nv_bfloat16) + (LN ? 2 * kw * sizeof(__nv_bfloat16) : 0) +
         2 * stages * sizeof(uint64_t);
}

// the clusters of `split` blocks of `kernel` at `smem` that the card holds
// at once (cudaOccupancyMaxActiveClusters), asked once per kernel, split
// and size
inline int active_clusters(const void* kernel, int split, size_t smem) {
  static std::mutex mu;
  static std::unordered_map<const void*, std::unordered_map<uint64_t, int>> known;
  std::lock_guard<std::mutex> lock(mu);
  auto& of = known[kernel];
  const uint64_t key = (uint64_t)split << 32 | (uint64_t)smem;
  auto it = of.find(key);
  if (it != of.end()) return it->second;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)split;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)split);
  cfg.blockDim = dim3(WS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess || cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    n = 0;
  return of[key] = n;
}

// mlp_stream_kernel's grid for NT n tiles: clusters of `split` blocks, as
// many as fit beside a block of the launch before on every SM (one block an
// SM), more where a cluster would otherwise take more than WS_MAX_TILES
// tiles.  The split (1, 2, 4 or 8) is the one whose busiest block takes the
// fewest stages (times the waves of clusters), the smaller on a tie, among
// those whose block fits WS_SMEM_MAX: at C = 1280, F = 5120 fc1 takes 2
// (66 clusters of 4-5 tiles, half the inputs each), fc2 8 (15 clusters of
// 5-6 tiles, an eighth of the inputs each), so a block streams 100-120 KB
// of bf16 weights where 13.1 MB over 132 SMs is 99 KB.  Row tiles of 16
// rows are the grid's y, each streaming the weights (from L2 after the
// first).
template <typename WT, int NT, bool LN, bool GELU, bool RESID>
void stream_grid(Chain& chain, const CUtensorMap& tw, const __nv_bfloat16* x, int n_rows, int n_in,
                 const __nv_bfloat16* g, const __nv_bfloat16* b, Segments<__nv_bfloat16, WT> seg, int n_out) {
  constexpr int KC = 128 / (int)sizeof(WT);
  const void* kernel = reinterpret_cast<const void*>(mlp_stream_kernel<WT, NT, LN, GELU, RESID>);
  const int sms = sm_count(), tiles = (n_out + TILE_ROWS - 1) / TILE_ROWS, chunks = (n_in + KC - 1) / KC;
  int split = 0, clusters = 0, per = 0, stages = 0;
  size_t smem = 0;
  long best = 0;
  for (int sp = 1; sp <= WS_MAX_SPLIT && sp <= chunks; sp *= 2) {
    // the clusters that fit beside a block of the launch before on every SM
    // (shared memory for one block an SM): 15 of eight blocks, not 16, on an
    // H100, whose GPCs are not all a multiple of eight SMs
    const int fit = active_clusters(kernel, sp, WS_ONE_PER_SM);
    if (fit < 1) continue;
    const int q = max(min(sms / sp, fit), (tiles + WS_MAX_TILES - 1) / WS_MAX_TILES);
    const int tmax = (tiles + q - 1) / q, pr = (chunks + sp - 1) / sp;
    int st = WS_STAGES;  // the deepest ring that fits, at least WS_MIN_STAGES deep
    while (st > WS_MIN_STAGES && stream_smem<WT, LN>(NT, tmax, sp, pr, st) > WS_SMEM_MAX) --st;
    const size_t sm = stream_smem<WT, LN>(NT, tmax, sp, pr, st);
    // the stages a block takes (a stage takes a warp's time, whether or not
    // every warp has a box in it), times the waves of clusters
    const long cost = (long)((tmax + WS_CONSUMERS - 1) / WS_CONSUMERS) * pr * ((q + fit - 1) / fit);
    if (sm <= WS_SMEM_MAX && (split == 0 || cost < best))
      split = sp, clusters = q, per = pr, stages = st, smem = sm, best = cost;
  }
  // every SM's shared memory as shared memory, so that a block of the next
  // launch (fc2 after fc1) fits beside this one: a carveout chosen for this
  // kernel alone holds two of its blocks and may leave too little for a
  // larger block of the next
  static const cudaError_t carveout =
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (split == 0 || carveout != cudaSuccess) {
    chain.fail(split == 0 ? cudaErrorInvalidConfiguration : carveout);
    return;
  }
  chain.launch(mlp_stream_kernel<WT, NT, LN, GELU, RESID>, dim3(clusters * split, (n_rows + TILE_ROWS - 1) / TILE_ROWS),
               WS_THREADS, smem, split, tw, x, n_rows, n_in, n_out, g, b, seg, per, stages);
}

// K5's products in bf16: out = epilogue(W . h) for W = seg.w[0] (n_out,
// n_in) through mlp_stream_kernel, its TMA map built here per launch (a
// launch captured in a CUDA graph keeps its own)
template <typename WT, bool LN, bool GELU, bool RESID>
void stream_launch(Chain& chain, const __nv_bfloat16* x, int n_rows, int n_in, const __nv_bfloat16* g,
                   const __nv_bfloat16* b, Segments<__nv_bfloat16, WT> seg, int n_out) {
  constexpr bool W8 = std::is_same<WT, int8_t>::value;
  const WT* w = seg.w[0];
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (LN && (reinterpret_cast<uintptr_t>(g) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0))) {
    chain.fail(cudaErrorMisalignedAddress);
    return;
  }
  if (n_in % 8 != 0 || (LN && n_in > 256 * LN_VECS)) {
    chain.fail(cudaErrorInvalidValue);
    return;
  }
  CUtensorMap tw;
  const uint64_t dims[2] = {(uint64_t)n_in, (uint64_t)n_out};
  const uint64_t strides[1] = {(uint64_t)n_in * sizeof(WT)};
  const uint32_t box[2] = {128 / (uint32_t)sizeof(WT), (uint32_t)TILE_ROWS};
  if (hopper::make_tmap(&tw, W8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 2, dims,
                        strides, box) != 0) {
    chain.fail(cudaErrorInvalidValue);
    return;
  }
  if (min(n_rows, TILE_ROWS) <= 8)
    stream_grid<WT, 1, LN, GELU, RESID>(chain, tw, x, n_rows, n_in, g, b, seg, n_out);
  else
    stream_grid<WT, 2, LN, GELU, RESID>(chain, tw, x, n_rows, n_in, g, b, seg, n_out);
}

// cross-attention launch for A audios of G rows each: the kernel instance
// for the largest NQ <= 8 that divides G, over A * G / NQ query groups;
// the G / NQ groups of an audio read its K/V (one audio's stride apart).
// int8 K/V carry their scales, (A, H, D) each.
template <typename T, typename KT>
void cross_attention(Chain& chain, int G, int A, size_t stride, int n_head, int C, int ta, const T* q,
                     const KT* k, const KT* v, const float* k_scale, const float* v_scale, T* out) {
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  int per = 8;
  while (G % per) --per;
  const Attn<T, KT> a = {q, k, v, nullptr, nullptr, out, n_head, C, stride, G, nullptr, ta, ta,
                         (float)pow((double)HD, Q8 ? -0.5 : -0.25), k_scale, v_scale,
                         nullptr, nullptr, 0, 0, 0, 0};
  const int groups = A * (G / per);
  switch (per) {
    case 1: attention_launch<T, KT, 1>(chain, groups, a, CROSS_KEYS); break;
    case 2: attention_launch<T, KT, 2>(chain, groups, a, CROSS_KEYS); break;
    case 3: attention_launch<T, KT, 3>(chain, groups, a, CROSS_KEYS); break;
    case 4: attention_launch<T, KT, 4>(chain, groups, a, CROSS_KEYS); break;
    case 5: attention_launch<T, KT, 5>(chain, groups, a, CROSS_KEYS); break;
    case 6: attention_launch<T, KT, 6>(chain, groups, a, CROSS_KEYS); break;
    case 7: attention_launch<T, KT, 7>(chain, groups, a, CROSS_KEYS); break;
    default: attention_launch<T, KT, 8>(chain, groups, a, CROSS_KEYS); break;
  }
}

// K5, and K2's MLP stage: out (B, C) = x + fc2(gelu(fc1(LayerNorm(x)))),
// in place where out is x, through ff (B, F) of scratch; weights (F, C)
// and (C, F) of type WT with scales s1 (F) and s2 (C) when int8 (else
// null), biases may be null.  bf16: mlp_stream_kernel (x, ff, ln_g, ln_b
// and the weights 16-byte aligned, C <= 2048); f32: the CUDA-core GEMV.
template <typename T, typename WT>
void mlp_stage(Chain& chain, const T* x, T* out, T* ff, int B, int C, int F, const T* ln_g, const T* ln_b,
               const WT* w1, const float* s1, const T* b1, const WT* w2, const float* s2, const T* b2) {
  Segments<T, WT> s_fc1 = {{w1}, {s1}, {b1}, {ff}};
  Segments<T, WT> s_fc2 = {{w2}, {s2}, {b2}, {out}, x == out ? nullptr : x};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    stream_launch<WT, true, true, false>(chain, x, B, C, ln_g, ln_b, s_fc1, F);
    stream_launch<WT, false, false, true>(chain, ff, B, F, nullptr, nullptr, s_fc2, C);
  } else {
    gemv<T, WT, true, true, false>(chain, x, B, C, ln_g, ln_b, s_fc1, F, F);
    gemv<T, WT, false, false, true>(chain, ff, B, F, nullptr, nullptr, s_fc2, C, C);
  }
}

// one step's arguments, as fused_decoder_layers takes them
struct Step {
  int L, B, A, C, H, t_cap, t, ta;
  int row0, B_total;                // this slice's first row; the tensors' rows
  int a0, A_total;                  // this slice's first audio; the tensors' audios
  int W, pend_w;                    // pending block: W columns, pend_w valid (W = 0: none)
  const void *pend_k, *pend_v;      // (L, B, H, D, W) each, or null
  const int* positions;
  const void *x, *self_k, *self_v, *cross_k, *cross_v;
  const float *cross_k_scale, *cross_v_scale;  // (L, A, H, D) each, int8 K/V
  void *out, *k_new, *v_new, *scratch;
  const void* const* table;     // N_WEIGHTS pointers
  const float* const* scales;   // N_PROJ pointers, int8 weights
};

// weights WT (T or int8_t), cross K/V KT (T or int8_t)
template <typename T, typename WT, typename KT>
int run(const Step& a, cudaStream_t stream) {
  const int L = a.L, B = a.B, A = a.A, C = a.C, H = a.H, t_cap = a.t_cap, ta = a.ta;
  constexpr bool W8 = std::is_same<WT, int8_t>::value;
  constexpr bool KV8 = std::is_same<KT, int8_t>::value;
  // this slice's rows [row0, row0 + B) of B_total, audios [a0, a0 + A) of
  // A_total; layer strides count every row (audio) of the tensors
  const size_t row0 = a.row0, Bt = a.B_total;
  const size_t a0 = a.a0, At = a.A_total;
  const T* x = static_cast<const T*>(a.x) + row0 * C;
  T* out = static_cast<T*>(a.out) + row0 * C;
  T* k_new = static_cast<T*>(a.k_new) + row0 * C;
  T* v_new = static_cast<T*>(a.v_new) + row0 * C;
  const int* positions = a.positions != nullptr ? a.positions + row0 : nullptr;
  T* q = static_cast<T*>(a.scratch);     // (B, C): q (self, then cross)
  T* attn = q + (size_t)B * C;           // (B, C): attention output, merged heads
  T* ff = attn + (size_t)B * C;          // (B, 4C): fc1 + GELU output

  const float scale = (float)pow((double)HD, -0.25);
  const size_t cc = (size_t)C * C;
  const size_t self_row = (size_t)H * HD * t_cap, cross_row = (size_t)H * HD * ta;
  const T* self_k = static_cast<const T*>(a.self_k) + row0 * self_row;
  const T* self_v = static_cast<const T*>(a.self_v) + row0 * self_row;
  const KT* cross_k = static_cast<const KT*>(a.cross_k) + a0 * cross_row;
  const KT* cross_v = static_cast<const KT*>(a.cross_v) + a0 * cross_row;
  // self-attention: every row at t, or row b at positions[b] clamped to
  // [0, t_cap]
  const int n_max = positions != nullptr ? t_cap : a.t;
  const size_t pend_row = (size_t)H * HD * a.W;
  const T* pend_k = a.pend_k != nullptr ? static_cast<const T*>(a.pend_k) + row0 * pend_row : nullptr;
  const T* pend_v = a.pend_v != nullptr ? static_cast<const T*>(a.pend_v) + row0 * pend_row : nullptr;

  Chain chain(stream);
  for (int l = 0; l < L; ++l) {
    auto p = [&](W i, size_t per_layer) {  // LayerNorm and bias entries
      return static_cast<const T*>(a.table[i]) + l * per_layer;
    };
    auto w = [&](W i, size_t per_layer) {  // projection weights
      return static_cast<const WT*>(a.table[i]) + l * per_layer;
    };
    auto sc = [&](PROJ j, size_t per_layer) -> const float* {  // their scales
      return W8 ? a.scales[j] + l * per_layer : nullptr;
    };
    T* kn = k_new + (size_t)l * Bt * C;
    T* vn = v_new + (size_t)l * Bt * C;

    // the first layer reads x; its o projection adds the residual to x and
    // writes the hidden state, which every later launch updates in place
    const T* h_in = l == 0 ? x : out;
    Segments<T, WT> s_qkv = {{w(Q_W, cc), w(K_W, cc), w(V_W, cc)},
                             {sc(P_Q, C), sc(P_K, C), sc(P_V, C)},
                             {p(Q_B, C), nullptr, p(V_B, C)},
                             {q, kn, vn}};
    gemv<T, WT, true, false, false>(chain, h_in, B, C, p(ATTN_LN_G, C), p(ATTN_LN_B, C), s_qkv, C, 3 * C);
    const Attn<T, T> self = {q, self_k + l * Bt * self_row, self_v + l * Bt * self_row, kn, vn, attn, H, C,
                             self_row, 1, positions, n_max, t_cap, scale, nullptr, nullptr,
                             pend_k != nullptr ? pend_k + l * Bt * pend_row : nullptr,
                             pend_v != nullptr ? pend_v + l * Bt * pend_row : nullptr, a.W, a.pend_w, 0, 0};
    if (pend_k != nullptr)
      attention_launch<T, T, 1, true>(chain, B, self, SELF_KEYS);
    else
      attention_launch<T, T, 1>(chain, B, self, SELF_KEYS);
    Segments<T, WT> s_o = {{w(O_W, cc)}, {sc(P_O, C)}, {p(O_B, C)}, {out}, l == 0 ? x : nullptr};
    gemv<T, WT, false, false, true>(chain, attn, B, C, nullptr, nullptr, s_o, C, C);

    Segments<T, WT> s_xq = {{w(XQ_W, cc)}, {sc(P_XQ, C)}, {p(XQ_B, C)}, {q}};
    gemv<T, WT, true, false, false>(chain, out, B, C, p(XATTN_LN_G, C), p(XATTN_LN_B, C), s_xq, C, C);
    const size_t kv_scales = ((size_t)l * At + a0) * C;  // (L, A_total, H, D) scales
    cross_attention<T, KT>(chain, B / A, A, cross_row, H, C, ta, q, cross_k + l * At * cross_row,
                           cross_v + l * At * cross_row,
                           KV8 ? a.cross_k_scale + kv_scales : nullptr,
                           KV8 ? a.cross_v_scale + kv_scales : nullptr, attn);
    Segments<T, WT> s_xo = {{w(XO_W, cc)}, {sc(P_XO, C)}, {p(XO_B, C)}, {out}};
    gemv<T, WT, false, false, true>(chain, attn, B, C, nullptr, nullptr, s_xo, C, C);

    mlp_stage<T, WT>(chain, out, out, ff, B, C, 4 * C, p(MLP_LN_G, C), p(MLP_LN_B, C), w(FC1_W, 4 * cc),
                     sc(P_FC1, 4 * C), p(FC1_B, 4 * C), w(FC2_W, 4 * cc), sc(P_FC2, C), p(FC2_B, C));
  }
  return chain.result();
}

template <typename T>
int run_weights(int w_int8, int kv_int8, const Step& a, cudaStream_t stream) {
  if (w_int8)
    return kv_int8 ? run<T, int8_t, int8_t>(a, stream) : run<T, int8_t, T>(a, stream);
  return kv_int8 ? run<T, T, int8_t>(a, stream) : run<T, T, T>(a, stream);
}

}  // namespace

// One slice of the step: rows [row0, row0 + B) (1 <= B <= 128) of A
// audios [a0, a0 + A), B / A rows each, of tensors that hold B_total rows
// and A_total audios, indexed from those (see the header); row0 = a0 = 0,
// B_total = B and A_total = A for a whole step.
// positions: the rows' positions t[b], int32 in device memory, or null for
// one position t (0 <= t <= t_cap) shared by every row.  w_int8: the eight
// projections are int8 with their scales in scale_table (N_PROJ pointers);
// kv_int8: the cross K/V are int8 with scales (L, A, H, D) each.  pend_k,
// pend_v: a pending block (L, B, H, D, W) of the compute dtype, both or
// neither (W = 0, pend_w = 0); with it the positions are the block's start
// and the first pend_w of its W columns are attended (0 <= pend_w <= W).
extern "C" int fused_decoder_layers(int dtype, int w_int8, int kv_int8, int L, int B, int A,
                                    int row0, int B_total, int a0, int A_total,
                                    int C, int H, int t_cap, int t, int ta, int W, int pend_w,
                                    const void* positions, const void* x, void* out,
                                    void* k_new, void* v_new, const void* self_k,
                                    const void* self_v, const void* cross_k, const void* cross_v,
                                    const void* cross_k_scale, const void* cross_v_scale,
                                    const void* table, const void* scale_table,
                                    const void* pend_k, const void* pend_v, void* scratch,
                                    void* stream) {
  const bool pending = pend_k != nullptr;
  if (C != H * HD || C % 16 != 0 || B < 1 || B > MAX_ROWS || A < 1 || B % A != 0 ||
      row0 < 0 || row0 + B > B_total || a0 < 0 || a0 + A > A_total ||
      t < 0 || t > t_cap || ta <= 0 || (w_int8 && scale_table == nullptr) ||
      (kv_int8 && (cross_k_scale == nullptr || cross_v_scale == nullptr)) ||
      pending != (pend_v != nullptr) || (pending ? W < 1 || W > MAX_PEND : W != 0) ||
      pend_w < 0 || pend_w > W)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {self_k, self_v, cross_k, cross_v, pend_k, pend_v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const Step a = {L, B, A, C, H, t_cap, t, ta, row0, B_total, a0, A_total, W, pend_w, pend_k, pend_v,
                  static_cast<const int*>(positions), x, self_k,
                  self_v, cross_k, cross_v, static_cast<const float*>(cross_k_scale),
                  static_cast<const float*>(cross_v_scale), out, k_new, v_new, scratch,
                  static_cast<const void* const*>(table),
                  static_cast<const float* const*>(scale_table)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16) return run_weights<__nv_bfloat16>(w_int8, kv_int8, a, s);
  if (dtype == DTYPE_F32) return run_weights<float>(w_int8, kv_int8, a, s);
  return (int)cudaErrorInvalidValue;
}

// K2's cross-attention launch on its own: q (A * G, C) of the compute
// dtype against A audios' K/V (A, H, D, ta), of the compute dtype or int8
// (kv_int8) with f32 scales (A, H, D) each; out (A * G, C)
extern "C" int decode_cross_attention(int dtype, int kv_int8, int A, int G, int C, int H, int ta,
                                      const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, void* out, void* stream) {
  if (C != H * HD || A < 1 || G < 1 || ta < 1 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Chain chain(static_cast<cudaStream_t>(stream));
  const size_t stride = (size_t)H * HD * ta;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
#define CROSS(T)                                                                                       \
  do {                                                                                                 \
    if (kv_int8)                                                                                       \
      cross_attention<T, int8_t>(chain, G, A, stride, H, C, ta, static_cast<const T*>(q),              \
                                 static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), ks, vs, \
                                 static_cast<T*>(out));                                                \
    else                                                                                               \
      cross_attention<T, T>(chain, G, A, stride, H, C, ta, static_cast<const T*>(q),                   \
                            static_cast<const T*>(k), static_cast<const T*>(v), nullptr, nullptr,      \
                            static_cast<T*>(out));                                                     \
  } while (0)
  if (dtype == DTYPE_BF16) CROSS(__nv_bfloat16);
  else if (dtype == DTYPE_F32) CROSS(float);
  else return (int)cudaErrorInvalidValue;
#undef CROSS
  return chain.result();
}

// K5: out (B, C) = x + fc2(gelu(fc1(LayerNorm(x)))), K2's MLP stage on its
// own; w1 (F, C), w2 (C, F) in the compute dtype, or int8 (w_int8) with f32
// scales s1 (F) and s2 (C); b1, b2 may be null; scratch holds B * F
// elements of the compute dtype
extern "C" int mlp_fused(int dtype, int w_int8, int B, int C, int F, const void* x, void* out,
                         const void* ln_g, const void* ln_b, const void* w1, const void* s1,
                         const void* b1, const void* w2, const void* s2, const void* b2,
                         void* scratch, void* stream) {
  if (B < 1 || B > MAX_ROWS || C % 16 != 0 || F % 16 != 0 ||
      (w_int8 && (s1 == nullptr || s2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(s1);
  const float* f2 = static_cast<const float*>(s2);
#define MLP(T, WT)                                                                             \
  do {                                                                                         \
    Chain chain(s);                                                                            \
    mlp_stage<T, WT>(chain, static_cast<const T*>(x), static_cast<T*>(out),                    \
                     static_cast<T*>(scratch), B, C, F, static_cast<const T*>(ln_g),           \
                     static_cast<const T*>(ln_b), static_cast<const WT*>(w1),                  \
                     w_int8 ? f1 : nullptr, static_cast<const T*>(b1),                         \
                     static_cast<const WT*>(w2), w_int8 ? f2 : nullptr,                        \
                     static_cast<const T*>(b2));                                               \
    return chain.result();                                                                     \
  } while (0)
  if (dtype == DTYPE_BF16) {
    if (w_int8) MLP(__nv_bfloat16, int8_t);
    MLP(__nv_bfloat16, __nv_bfloat16);
  }
  if (dtype == DTYPE_F32) {
    if (w_int8) MLP(float, int8_t);
    MLP(float, float);
  }
#undef MLP
  return (int)cudaErrorInvalidValue;
}

// the int8 logits: out (n_rows, V) f32 = (x (n_rows, C) . q (V, C)^T) *
// s (V), unrounded; K2's GEMV with int8 weights and an f32 epilogue
extern "C" int int8_logits(int dtype, int n_rows, int C, int V, const void* x, const void* q,
                           const void* s, void* out, void* stream) {
  if (n_rows < 1 || C % 16 != 0 || V < 1) return (int)cudaErrorInvalidValue;
  Chain chain(static_cast<cudaStream_t>(stream));
  const int8_t* w = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(s);
  if (dtype == DTYPE_BF16) {
    Segments<__nv_bfloat16, int8_t> seg = {{w}, {sc}, {nullptr}, {out}};
    gemv<__nv_bfloat16, int8_t, false, false, false, true>(
        chain, static_cast<const __nv_bfloat16*>(x), n_rows, C, nullptr, nullptr, seg, V, V);
  } else if (dtype == DTYPE_F32) {
    Segments<float, int8_t> seg = {{w}, {sc}, {nullptr}, {out}};
    gemv<float, int8_t, false, false, false, true>(chain, static_cast<const float*>(x), n_rows, C,
                                                   nullptr, nullptr, seg, V, V);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return chain.result();
}
