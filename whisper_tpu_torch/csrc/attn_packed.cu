// E3: the two-heads-packing experiment's score + PV pairs, unpacked and
// packed, with no softmax.
//
// Replaces scripts/_attn_packed_experiment.py:main's Pallas kernels
// kernel_unpacked and kernel_packed.  Per program i and each of its query
// rows, `reps` dependent iterations of
//   qq = q + bf16(acc) * 1e-9            (bf16: the constant and each op rounded)
//   s = qq . k^T (f32), o = bf16(s) . v (f32), acc += o * 1e-9 (f32)
// and the output bf16(acc).  Unpacked (NH = 2, HD = 64): q (Q, 128) holds
// two heads side by side, each with its own K/V (T, 64); packed (NH = 1, HD
// = 128): one (2T, 128) K/V pair, block-diagonal in the experiment.  The
// packed kernel is a dense product over whatever operands it gets: it
// multiplies the zero blocks too, which it cannot know are zero.
//
// What bounds it on an H100: each rep is 2 x 2 x Q x T x D products per
// head pair (4 x on the packed operands, half of them on zeros): 2.06e12
// (unpacked) and 4.12e12 (packed) operations at g = 320, Q = 128, T =
// 1536, D = 64, reps = 64, against a few MB of inputs: bound by the
// tensor cores (2.08 and 4.17 ms at 989 TFLOP/s).
//
// Design: the TPU program keeps its K/V and the (Q, T) score block in
// VMEM.  Here one program's K/V (786 KB unpacked, 1.5 MB packed) and its
// (128, 1536) f32 scores do not fit in 227 KB of shared memory.  With no
// softmax, o = sum over t of bf16(s[:, t]) v[t] is exact when tiled over T,
// so each rep streams 32-key tiles of K and V from L2 (cp.async, two in
// flight) and no score block is kept.  A query row's acc depends only on
// its own row, so a block takes 64 rows of a program (grid Q / 64 x g) with
// its own rep loop; each of its 4 warps owns 16 rows and keeps acc, qq,
// the tile's scores and the head's PV sum in mma.sync fragments (q is
// re-read at each rep's start, to spare 32 registers): the scores' C
// fragments, rounded to bf16, are the PV product's A fragments, and acc's
// are qq's (mma.cuh).  The f32 multiply and add of acc are separate
// roundings (__fmul_rn, __fadd_rn), never one FMA, as the script computes
// them.  wgmma is later work.

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4, ROWS = 16 * WARPS, BT = 32;

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }  // K/V tile row stride, conflict-free

// K and V rows [t0, t0 + BT) of one head, (T, HD) each, into tile (BT, HD + 8);
// rows at or past T load zeros (they add exact zeros to o)
template <int HD>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, int t0, int T) {
  constexpr int PER_ROW = HD / 8;
  for (int e = threadIdx.x; e < BT * PER_ROW; e += WARPS * 32) {
    const int r = e / PER_ROW, c = (e - r * PER_ROW) * 8;
    const bool valid = t0 + r < T;
    const size_t off = (size_t)(valid ? t0 + r : 0) * HD + c;
    cp_async16(ks + r * ld<HD>() + c, k + off, valid);
    cp_async16(vs + r * ld<HD>() + c, v + off, valid);
  }
}

template <int HD, int NH>
__global__ void __launch_bounds__(WARPS * 32)
attn_pairs_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k0,
                  const bf16* __restrict__ v0, const bf16* __restrict__ k1,
                  const bf16* __restrict__ v1, bf16* __restrict__ out, int Q, int T, int reps,
                  float eps_q) {
  constexpr int QC = NH * HD;       // q's columns
  constexpr int LD = ld<HD>();
  constexpr int TILE = 2 * BT * LD;  // one stage: K tile then V tile
  __shared__ __align__(16) uint16_t smem_raw[2 * TILE];  // two stages of bf16
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int prog = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row_lo = blockIdx.x * ROWS + warp * 16 + g, row_hi = row_lo + 8;
  const bf16* qp = q + (size_t)prog * Q * QC;
  const size_t kv = (size_t)prog * T * HD;

  // two of q's bf16 at (row, col), zeros past Q: A register r of the k16
  // tile at column c0 is rows lo, hi, lo, hi at columns c0 + 2 t (+ 8 for r >= 2)
  auto q_pair = [&](int r, int c0) -> uint32_t {
    const int row = (r & 1) ? row_hi : row_lo, col = c0 + 2 * tig + 8 * (r >> 1);
    return row < Q ? *reinterpret_cast<const uint32_t*>(qp + (size_t)row * QC + col) : 0u;
  };
  float acc[QC / 8][4];
#pragma unroll
  for (int j = 0; j < QC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nt = (T + BT - 1) / BT;
  const int total = reps * NH * nt;  // tiles in order: rep, head, key tile
  auto load = [&](int u) {
    const int h = (u / nt) % NH, t = u % nt;
    bf16* ks = smem + (u & 1) * TILE;
    load_kv<HD>(ks, ks + BT * LD, (h == 0 ? k0 : k1) + kv, (h == 0 ? v0 : v1) + kv, t * BT, T);
  };

  uint32_t qq[HD / 16][4];
  float o[HD / 8][4];
  load(0);
  cp_async_commit();
  for (int u = 0; u < total; ++u) {
    const int h = (u / nt) % NH, t = u % nt;
    if (u + 1 < total) load(u + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile u is in
    // the head is matched against an unrolled index, so that acc is only
    // ever indexed by constants and stays in registers
    if (t == 0) {  // a head's rep begins: qq = q + bf16(bf16(acc) * eps), o = 0
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        if (hh != h) continue;
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) {
          const int cq = hh * (HD / 16) + c;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* a = acc[2 * cq + (r >> 1)] + 2 * (r & 1);  // the C pair of A reg r
            const float2 qf = unpack_bf16x2(q_pair(r, 16 * cq));  // q is re-read (from L1/L2)
            const float lo = round_to<bf16>(__fmul_rn(round_to<bf16>(a[0]), eps_q));
            const float hi = round_to<bf16>(__fmul_rn(round_to<bf16>(a[1]), eps_q));
            qq[c][r] = pack_bf16x2(__fadd_rn(qf.x, lo), __fadd_rn(qf.y, hi));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    }
    const bf16* ks = smem + (u & 1) * TILE;
    const bf16* vs = ks + BT * LD;
    float s[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
      for (int n2 = 0; n2 < BT / 16; ++n2) {  // K rows as the B side (keys as n)
        uint32_t r[4];
        ldmatrix_x4(r, ks + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + c * 16 +
                           ((lane >> 3) & 1) * 8);
        const uint32_t b_lo[2] = {r[0], r[1]}, b_hi[2] = {r[2], r[3]};
        mma_bf16_m16n8k16(s[2 * n2], qq[c], b_lo);
        mma_bf16_m16n8k16(s[2 * n2 + 1], qq[c], b_hi);
      }
    }
#pragma unroll
    for (int c2 = 0; c2 < BT / 16; ++c2) {  // bf16(s) as A fragments, keys as k
      const uint32_t p[4] = {pack_bf16x2(s[2 * c2][0], s[2 * c2][1]),
                             pack_bf16x2(s[2 * c2][2], s[2 * c2][3]),
                             pack_bf16x2(s[2 * c2 + 1][0], s[2 * c2 + 1][1]),
                             pack_bf16x2(s[2 * c2 + 1][2], s[2 * c2 + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {  // V rows by ldmatrix.trans (dims as n)
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (c2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + d2 * 16 +
                                 (lane >> 4) * 8);
        const uint32_t b_lo[2] = {r[0], r[1]}, b_hi[2] = {r[2], r[3]};
        mma_bf16_m16n8k16(o[2 * d2], p, b_lo);
        mma_bf16_m16n8k16(o[2 * d2 + 1], p, b_hi);
      }
    }
    if (t == nt - 1) {  // the head's rep ends: acc += o * 1e-9, two roundings
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        if (hh != h) continue;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[hh * (HD / 8) + j][e] = __fadd_rn(acc[hh * (HD / 8) + j][e], __fmul_rn(o[j][e], 1e-9f));
      }
    }
    __syncthreads();  // every warp is done with tile u's stage before u + 2 fills it
  }
  cp_async_wait<0>();

  bf16* op = out + (size_t)prog * Q * QC;
#pragma unroll
  for (int j = 0; j < QC / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    if (row_lo < Q)
      *reinterpret_cast<uint32_t*>(op + (size_t)row_lo * QC + col) = pack_bf16x2(acc[j][0], acc[j][1]);
    if (row_hi < Q)
      *reinterpret_cast<uint32_t*>(op + (size_t)row_hi * QC + col) = pack_bf16x2(acc[j][2], acc[j][3]);
  }
}

}  // namespace

// packed = 0: q (g, Q, 128), k0, v0, k1, v1 (g, T, 64) each; packed = 1: q
// (g, Q, 128), k0, v0 (g, T, 128) (T the packed length), k1, v1 unused;
// out (g, Q, 128); bf16, contiguous.  eps_q: 1e-9 as a bf16 value.
extern "C" int attn_pairs(int packed, int g, int Q, int T, int reps, float eps_q, const void* q,
                          const void* k0, const void* v0, const void* k1, const void* v1,
                          void* out, void* stream) {
  if (g < 1 || g > 65535 || Q < 1 || T < 1 || reps < 0 || (packed != 0 && packed != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Q + ROWS - 1) / ROWS, g);
  const bf16* qb = static_cast<const bf16*>(q);
  bf16* o = static_cast<bf16*>(out);
  if (packed)
    attn_pairs_kernel<128, 1><<<grid, WARPS * 32, 0, s>>>(
        qb, static_cast<const bf16*>(k0), static_cast<const bf16*>(v0), nullptr, nullptr, o, Q, T,
        reps, eps_q);
  else
    attn_pairs_kernel<64, 2><<<grid, WARPS * 32, 0, s>>>(
        qb, static_cast<const bf16*>(k0), static_cast<const bf16*>(v0), static_cast<const bf16*>(k1),
        static_cast<const bf16*>(v1), o, Q, T, reps, eps_q);
  return (int)cudaGetLastError();
}
