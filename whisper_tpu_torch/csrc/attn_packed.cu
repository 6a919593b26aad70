// E3: the two-heads-packing experiment's score + PV pairs, unpacked and
// packed, with no softmax.
//
// Replaces scripts/_attn_packed_experiment.py:main's Pallas kernels
// kernel_unpacked (:51) and kernel_packed (:75).  Per program and each of
// its query rows, `reps` dependent iterations of
//   qq = q + bf16(bf16(acc) * bf16(1e-9))   (bf16, each op rounded)
//   s = qq . k^T (f32), o = bf16(s) . v (f32), acc = acc + o * 1e-9 (f32,
//   the product and the sum rounded apart, never one FMA)
// and the output bf16(acc).  Unpacked (HD = 64): q (Q, 128) holds two heads
// side by side, each with its own K/V (T, 64); packed (HD = 128): one (2T,
// 128) K/V pair, block-diagonal in the experiment.  The packed kernel is a
// dense product over whatever operands it gets: it multiplies the zero
// blocks too, which it cannot know are zero.
//
// What bounds it on an H100: each rep is 2 x 2 x Q x T x D products per
// head pair (4x that on the packed operands, half of them on zeros):
// 2.06e12 (unpacked) and 4.12e12 (packed) operations at g = 320, Q = 128,
// T = 1536, D = 64, reps = 64: 2.08 and 4.17 ms at 989 TFLOP/s.  Read
// once, its K/V is 252 MB (503 MB packed): 0.075 and 0.150 ms at 3.35
// TB/s.  So the tensor cores bound it, if each program's K/V is read from
// device memory once and not once a rep.
//
// The trace (PERF.md; H100 80GB HBM3, 700 W): the kernel before this
// one took 64 query rows a block and streamed the program's
// whole K/V in 32-key tiles every rep, 32.2 GB to the SMs (64.4 GB
// packed) at g = 320, reps = 64, in 9.37 ms (18.74): 3.44 TB/s, more than
// device memory gives, so L2 served part of it.  At g = 32, K/V inside L2,
// its time per program was 3.7x (2.7x) longer: 64 lone blocks of 4 warps,
// each latency-bound.  It was held by streaming every tile every rep and
// by each block's latency, not by device memory alone.
//
// Design: the TPU kernel keeps a program's K/V in VMEM.  One head's K/V
// (393,216 bytes; the packed program's 1,572,864) needs the shared memory
// of several blocks, so a thread-block cluster holds it, split by keys:
// `keys` (a multiple of 64, at most 384 at HD = 64 and 192 at HD = 128,
// 98,304 bytes of K and V) a block, loaded by TMA once, at the start.  A
// chain is one head (unpacked) or one packed program, for 128 query rows;
// CL blocks hold it: 4 up to 4 x MAX_KEYS keys (T = 1536 unpacked), else
// 16 (a non-portable cluster: the packed 3072 keys).  With no softmax, o = sum over the keys of
// bf16(s) v splits exactly into per-block partial sums.
//
// A block is two warpgroups, each owning a 64-row half of the chain's
// rows; the halves are independent chains (they run unsynchronised: an
// offset start, half 1 after half 0's first products, measured no
// different).  The half's rows are owned 64 / CL a block.  Each rep, per
// half:
//  - S = qq K_chunk^T by wgmma (A: qq's fragments in registers, B: the
//    chunk's 64 keys in shared memory), 64 keys at a time; bf16(S) in
//    registers is the A operand of o += P V_chunk (wgmma RS, V MN-major),
//    as csrc/attention.cu does for K1;
//  - each thread sends its accumulators (the block's partial o) to the
//    rows' owners by st.async: 16 bytes a store (lanes t and t ^ 1 pair
//    their columns) into the owner's shared memory, in this block's slot,
//    counted on the owner's barrier as transaction bytes (hopper.cuh), so
//    the bytes themselves complete the phase;
//  - the owner, its barrier complete, adds the blocks' partials in rank
//    order (0, 1, ..., CL - 1), updates its acc (registers, the same
//    elements every rep), forms qq and sends it by st.async into every
//    block's qq buffer (16 bytes a store where a thread owns 8 values),
//    whose barrier completes on those bytes: the next rep starts.  A
//    block's slots are written again only after their owner has read them
//    (the writers first wait for the qq it sends after).
// A block reads its K/V from device memory once, whatever reps is; the
// cluster moves (CL - 1) / CL of the partial sums and qq between the SMs
// each rep.  Keys past T load as zeros (TMA's fill), which add exact zeros
// to o; rows past Q compute on zeros and are not written.
//
// What holds it now (chip_trace_e3.py, clock64 over a rep's phases): the
// exchange between the SMs, not the products.  Unpacked, a rep of a block
// is some 6400-6800 cycles, of which the products are 2700-3100 and the
// exchange the rest; the exchange alone (no products) runs 2.6-3.4 ms of
// the kernel's 5.0-5.3.  Packed, each block sends twice the bytes to 15
// others: the exchange alone is 15 ms of 19.  An H100 holds 30 clusters of
// 4 of these blocks at once and 7 of 16 (120 and 112 SMs).

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;                // keys a chunk: S's N, P V's K
constexpr uint32_t BOX = KC * 128;    // one TMA box: 64 keys x 64 dims, 128-byte rows
constexpr int THREADS = 256;          // two warpgroups, a 64-row half each
constexpr int QC = 128;               // q's and the output's columns

template <int HD>
struct Layout {
  static constexpr int NB = HD / 64;                     // 64-dim boxes a key row
  static constexpr int NH = HD == 64 ? 2 : 1;            // chains (heads) a program
  static constexpr int MAX_KEYS = HD == 64 ? 384 : 192;  // keys a block holds
  static constexpr int MAX_CHUNKS = MAX_KEYS / KC;
  static constexpr uint32_t CHUNK_BYTES = 2 * NB * BOX;  // a chunk's K and V
  static constexpr int PLD = HD + 8;  // the received partials' row stride (floats)
  static constexpr int QLD = HD + 8;  // qq's row stride (bf16): fragment loads conflict-free
  static constexpr size_t KV_BYTES = (size_t)MAX_CHUNKS * CHUNK_BYTES;
  static constexpr size_t RECV_BYTES = 2 * 64 * PLD * sizeof(float);  // [half][rank][64 / CL rows][PLD]
  static constexpr size_t QQ_BYTES = 2 * 64 * QLD * sizeof(bf16);
  static constexpr int N_BARRIERS = MAX_CHUNKS + 4;
  static constexpr size_t SMEM = 1024 + KV_BYTES + RECV_BYTES + QQ_BYTES + 8 * N_BARRIERS;
  // the bytes that complete a phase of a half's barriers: every block's
  // partial of the rows a block owns, and the owners' qq of all 64 rows
  static constexpr uint32_t PARTIAL_BYTES = 64 * HD * sizeof(float), QQ_DATA_BYTES = 64 * HD * sizeof(bf16);
  static_assert(SMEM <= 232448, "a block's shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// VEC floats (2, 4 or 8) from p
template <int VEC>
__device__ __forceinline__ void load_vec(float* v, const float* p) {
  if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      v[i] = x.x, v[i + 1] = x.y, v[i + 2] = x.z, v[i + 3] = x.w;
    }
  }
}

// VEC bf16 (VEC / 2 pairs) into block `rank`'s shared memory at p, counted on its barrier bar
template <int VEC>
__device__ __forceinline__ void send_pairs(const bf16* p, const uint32_t* v, uint64_t* bar, int rank) {
  const uint32_t dst = hopper::cluster_addr(p, rank), b = hopper::cluster_addr(bar, rank);
  if constexpr (VEC == 8)
    hopper::st_async(dst, make_uint4(v[0], v[1], v[2], v[3]), b);
  else if constexpr (VEC == 4)
    hopper::st_async(dst, v[0], v[1], b);
  else
    hopper::st_async(dst, v[0], b);
}

// VEC bf16 to p in global memory
template <int VEC>
__device__ __forceinline__ void store_pairs(bf16* p, const uint32_t* v) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  else if constexpr (VEC == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  else
    *reinterpret_cast<uint32_t*>(p) = v[0];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One chain (a head, or a packed program, for 128 query rows) on a cluster
// of CL blocks; see the header.  Maps: (HD, T, g) over K and V, boxes of 64
// dims x 64 keys; tk1, tv1: head 1's (unpacked).
template <int HD, int CL>
__global__ void __launch_bounds__(THREADS, 1)
attn_pairs_cluster_kernel(const __grid_constant__ CUtensorMap tk0, const __grid_constant__ CUtensorMap tv0,
                          const __grid_constant__ CUtensorMap tk1, const __grid_constant__ CUtensorMap tv1,
                          const bf16* __restrict__ q, bf16* __restrict__ out, int Q, int T, int reps,
                          int keys, int n_rg, float eps_q) {
  using L = Layout<HD>;
  constexpr int R = 64 / CL;               // rows of each half a block owns
  constexpr int OWN = R * HD / 128;        // elements each thread of a warpgroup owns
  constexpr int VEC = OWN >= 8 ? 8 : OWN;  // in vectors of VEC, 128 vectors apart
  constexpr int NV = OWN / VEC;
  static_assert(OWN >= 2 && OWN % VEC == 0, "ownership");

  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + L::MAX_CHUNKS * L::NB * BOX;
  float* recv = reinterpret_cast<float*>(Vs + L::MAX_CHUNKS * L::NB * BOX);  // [2][CL][R][PLD]
  bf16* qq = reinterpret_cast<bf16*>(recv + 2 * 64 * L::PLD);                // [2][64][QLD]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(qq + 2 * 64 * L::QLD);     // [MAX_CHUNKS]
  uint64_t* pready = kv_full + L::MAX_CHUNKS;  // [2]: the owned rows' partials from every block are in
  uint64_t* qready = pready + 2;               // [2]: every owner's qq of the half is in

  const int rank = (int)cluster.block_rank();
  const int chain = (int)blockIdx.x / CL, rg = chain % n_rg, ph = chain / n_rg;
  const int head = ph % L::NH, prog = ph / L::NH;
  const int k0 = rank * keys;
  const int nck = (max(0, min(keys, T - k0)) + KC - 1) / KC;  // this block's key chunks
  const int h = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int w = tid / 32, g = (tid % 32) / 4, t = tid % 4;

  if (threadIdx.x == 0) {
    for (int c = 0; c < L::MAX_CHUNKS; ++c) hopper::mbar_init(kv_full + c, 1);
    for (int hh = 0; hh < 2; ++hh) {  // each armed for its first phase
      hopper::mbar_init(pready + hh, 1);
      hopper::mbar_init(qready + hh, 1);
      hopper::mbar_arrive_expect_tx(pready + hh, L::PARTIAL_BYTES);
      hopper::mbar_arrive_expect_tx(qready + hh, L::QQ_DATA_BYTES);
    }
    hopper::mbar_fence_init();
  }
  __syncwarp();  // the warp meets the cluster barrier converged
  cluster.sync();  // every block's barriers are armed before any block stores into it

  if (threadIdx.x == 0) {  // the block's K/V slice, once
    const CUtensorMap* mk = head == 0 ? &tk0 : &tk1;
    const CUtensorMap* mv = head == 0 ? &tv0 : &tv1;
    for (int c = 0; c < nck; ++c) {
      hopper::mbar_arrive_expect_tx(kv_full + c, L::CHUNK_BYTES);
#pragma unroll
      for (int b = 0; b < L::NB; ++b) {
        hopper::tma_load_3d(Ks + (c * L::NB + b) * BOX, mk, kv_full + c, 64 * b, k0 + c * KC, prog);
        hopper::tma_load_3d(Vs + (c * L::NB + b) * BOX, mv, kv_full + c, 64 * b, k0 + c * KC, prog);
      }
    }
  }

  // the elements this thread owns: vector v is the half's owned rows'
  // (R x HD, row-major) vector v * 128 + tid, of VEC columns: row orow[v]
  // of the owned R, column ocol[v]
  const size_t qbase = (size_t)prog * Q * QC + head * 64;
  int orow[NV], ocol[NV];
  float acc[OWN];
  uint32_t qv[OWN / 2];  // q's bf16 pairs (zeros past Q)
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (v * 128 + tid) * VEC;
    orow[v] = e / HD, ocol[v] = e % HD;
    const int row = rg * 128 + h * 64 + rank * R + orow[v];
#pragma unroll
    for (int i = 0; i < VEC; i += 2)
      qv[(v * VEC + i) / 2] =
          row < Q ? *reinterpret_cast<const uint32_t*>(q + qbase + (size_t)row * QC + ocol[v] + i) : 0u;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v * VEC + i] = 0.f;
  }
  bf16* qq_half = qq + h * 64 * L::QLD;
  const float* recv_half = recv + h * 64 * L::PLD;

  // qq = q + bf16(bf16(acc) * eps) for the owned elements, into every
  // block's qq buffer of this half
  auto publish = [&]() {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      uint32_t pairs[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC; i += 2) {
        const float2 qf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[(v * VEC + i) / 2]));
        const float lo = round_to<bf16>(__fmul_rn(round_to<bf16>(acc[v * VEC + i]), eps_q));
        const float hi = round_to<bf16>(__fmul_rn(round_to<bf16>(acc[v * VEC + i + 1]), eps_q));
        pairs[i / 2] = pack_bf16x2(__fadd_rn(qf.x, lo), __fadd_rn(qf.y, hi));
      }
      const bf16* dst = qq_half + (rank * R + orow[v]) * L::QLD + ocol[v];
#pragma unroll
      for (int r = 0; r < CL; ++r) send_pairs<VEC>(dst, pairs, qready + h, r);
    }
  };

  if (reps > 0) publish();  // rep 0's qq: q itself
  uint32_t phase = 0;
  const bf16* qrow = qq_half + (16 * w + g) * L::QLD + 2 * t;
  for (int rep = 0; rep < reps; ++rep) {
    const bool more = rep + 1 < reps;
    hopper::mbar_wait<true>(qready + h, phase);
    if (tid == 0 && more) hopper::mbar_arrive_expect_tx(qready + h, L::QQ_DATA_BYTES);  // the next rep's
    // qq's A fragments: rows g, g + 8 of the warp's 16, columns 16 kk + 2 t (+ 8)
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(qrow + 16 * kk);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(qrow + 8 * L::QLD + 16 * kk);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(qrow + 16 * kk + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(qrow + 8 * L::QLD + 16 * kk + 8);
    }
    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    for (int c = 0; c < nck; ++c) {
      if (rep == 0) hopper::mbar_wait(kv_full + c, 0);
      // S = qq K_chunk^T (64 x 64 keys): K rows K-major, 128-byte swizzled
      float s[KC / 2];
      hopper::fence_operands(qf);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t db =
            hopper::smem_desc(Ks + (c * L::NB + kk / 4) * BOX + (kk % 4) * 32, 16, 1024);
        hopper::wgmma_rs<0>(s, qf[kk], db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();  // this chunk's S, and the last chunk's P V
      hopper::fence_operands(s);
      // bf16(S) as P V's A fragments: k16 step kk holds keys 16 kk ... + 15
      uint32_t pf[KC / 16][4];
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      // o += P V_chunk: V MN-major, its 64-dim boxes BOX bytes apart
      hopper::fence_operands(oacc);
      hopper::fence_operands(pf);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t db = hopper::smem_desc(Vs + c * L::NB * BOX + kk * 2048, BOX, 1024);
        hopper::wgmma_rs<1>(oacc, pf[kk], db, 1);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(oacc);

    // the block's partial o, each row to its owner: accumulator element
    // 4 j + 2 hh + e is row 16 w + g + 8 hh, column 8 j + 2 t + e; it
    // lands in the owner's slot of this block (rank), row (row mod R)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * w + g + 8 * hh, owner = row / R;
      // 16-byte stores: lanes t and t ^ 1 trade their pairs of column
      // block j, and the even lane sends the four columns of even j, the
      // odd lane those of odd j
      const uint32_t dst = hopper::cluster_addr(recv_half + (rank * R + row % R) * L::PLD + 2 * (t & ~1), owner);
      const uint32_t bar = hopper::cluster_addr(pready + h, owner);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float a = oacc[4 * j + 2 * hh], b = oacc[4 * j + 2 * hh + 1];
        const float pa = __shfl_xor_sync(0xffffffffu, a, 1), pb = __shfl_xor_sync(0xffffffffu, b, 1);
        if ((j & 1) == (t & 1)) {
          if (t & 1)
            hopper::st_async(dst + 32 * j, pa, pb, a, b, bar);
          else
            hopper::st_async(dst + 32 * j, a, b, pa, pb, bar);
        }
      }
    }
    hopper::mbar_wait<true>(pready + h, phase);
    if (tid == 0 && more) hopper::mbar_arrive_expect_tx(pready + h, L::PARTIAL_BYTES);
    phase ^= 1;

    // the owned elements' o, the blocks' partials added in rank order
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float parts[CL][VEC];
#pragma unroll
      for (int r = 0; r < CL; ++r) load_vec<VEC>(parts[r], recv_half + (r * R + orow[v]) * L::PLD + ocol[v]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float o = parts[0][i];
#pragma unroll
        for (int r = 1; r < CL; ++r) o = __fadd_rn(o, parts[r][i]);
        acc[v * VEC + i] = __fadd_rn(acc[v * VEC + i], __fmul_rn(o, 1e-9f));
      }
    }
    if (more) publish();
  }

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int row = rg * 128 + h * 64 + rank * R + orow[v];
    if (row < Q) {
      uint32_t pairs[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC; i += 2) pairs[i / 2] = pack_bf16x2(acc[v * VEC + i], acc[v * VEC + i + 1]);
      store_pairs<VEC>(out + qbase + (size_t)row * QC + ocol[v], pairs);
    }
  }
  if (threadIdx.x == 0)  // reps = 0 waits for nothing: the loads must land before the block exits
    for (int c = 0; c < nck; ++c) hopper::mbar_wait(kv_full + c, 0);
  __syncwarp();
  cluster.sync();
}

// (HD, T, g) over a K or V tensor (g, T, HD), boxes of 64 dims x KC keys;
// keys past T read as zeros
inline int kv_map(CUtensorMap* map, const void* base, int HD, int T, int g) {
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)T, (uint64_t)g};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)T * HD * 2};
  const uint32_t box[3] = {64, KC, 1};
  return hopper::make_tmap_bf16(map, base, 3, dims, strides, box);
}

template <int HD, int CL>
int launch(const void* q, const void* const* kv, void* out, int g, int Q, int T, int reps, float eps_q,
           cudaStream_t stream) {
  using L = Layout<HD>;
  auto kernel = attn_pairs_cluster_kernel<HD, CL>;
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i)
    if (kv_map(&maps[i], kv[i], HD, T, g) != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (e == cudaSuccess && CL > 8) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int keys = ((T + CL - 1) / CL + KC - 1) / KC * KC;
  const int n_rg = (Q + 127) / 128;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g * L::NH * n_rg * CL));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(q),
                         static_cast<bf16*>(out), Q, T, reps, keys, n_rg, eps_q);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// packed = 0: q (g, Q, 128), k0, v0, k1, v1 (g, T, 64) each; packed = 1: q
// (g, Q, 128), k0, v0 (g, T, 128) (T the packed length), k1, v1 unused;
// out (g, Q, 128); bf16, contiguous, 16-byte aligned.  T at most 6144
// unpacked (16 blocks of 384 keys), 3072 packed (16 of 192).  eps_q: 1e-9
// as a bf16 value.
extern "C" int attn_pairs(int packed, int g, int Q, int T, int reps, float eps_q, const void* q,
                          const void* k0, const void* v0, const void* k1, const void* v1,
                          void* out, void* stream) {
  if (g < 1 || Q < 1 || T < 1 || reps < 0 || (packed != 0 && packed != 1))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k0, v0, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    const void* kv[4] = {k0, v0, k0, v0};
    if (T <= 4 * Layout<128>::MAX_KEYS) return launch<128, 4>(q, kv, out, g, Q, T, reps, eps_q, s);
    if (T <= 16 * Layout<128>::MAX_KEYS) return launch<128, 16>(q, kv, out, g, Q, T, reps, eps_q, s);
    return (int)cudaErrorInvalidValue;
  }
  for (const void* p : {k1, v1})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const void* kv[4] = {k0, v0, k1, v1};
  if (T <= 4 * Layout<64>::MAX_KEYS) return launch<64, 4>(q, kv, out, g, Q, T, reps, eps_q, s);
  if (T <= 16 * Layout<64>::MAX_KEYS) return launch<64, 16>(q, kv, out, g, Q, T, reps, eps_q, s);
  return (int)cudaErrorInvalidValue;
}
