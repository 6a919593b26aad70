// K2: one greedy decode step through all L decoder layers, batch 1.
//
// Replaces whisper_tpu/ops/kernels/fused_step_pallas.py:fused_decoder_layers
// in its A=1, B=1, no-pending, unquantized variant.  Same contract: input x
// (1, C) is the token + position embedding; outputs are the hidden state
// after the last layer (no final LayerNorm) and each layer's new K/V as
// (L, 1, C); the KV-cache column write stays with the caller.  Per layer:
// ln1 -> q, k, v -> self-attention over cache positions < t plus the new
// token -> o + residual -> ln2 -> xq -> cross-attention over Ta -> xo +
// residual -> ln3 -> fc1 + GELU -> fc2 + residual.  LayerNorm statistics,
// softmax and every accumulation are f32; each intermediate is rounded to
// the compute dtype where models.whisper.decoder_step rounds it.
//
// What bounds it on an H100: at B = 1 every weight is read once per step
// for 2 flops per element, and cross-attention reads 2 * H * D * Ta cache
// elements per layer, so the step is bound by device-memory bytes
// (large-v3-turbo, bf16: ~46 MB of weights and ~7.7 MB of cross K/V per
// layer) and, at four layers, by the fixed cost of its launches.
//
// Design: the TPU kernel is one pallas_call whose (layer, phase) grid
// streams weight tiles through VMEM with the residual stream resident.
// Blocks on a GPU run in no order and share nothing, so this first form is
// eight launches per layer, queued back to back on one stream by one host
// call (no Python between them):
//   gemv  (LayerNorm prologue, q|k|v in one launch of 3C rows)
//   decode_attention (self: cache positions < t and the new token)
//   gemv  (o, + residual in place)      gemv (LayerNorm prologue, xq)
//   decode_attention (cross: Ta keys)
//   gemv  (xo, + residual)              gemv (LayerNorm prologue, fc1, GELU)
//   gemv  (fc2, + residual)
// The GEMV keeps torch's (out, in) weight layout so one warp reads one
// output's weight row with 16-byte loads; each block recomputes the
// LayerNorm of x (C values) into shared memory instead of paying a launch
// for it.  decode_attention gives each head a cluster of 8 blocks (a
// Hopper thread-block cluster) that split the keys; the blocks exchange
// their max, their sum and their partial outputs through distributed
// shared memory, so the softmax is still the exact one (weights normalised
// before they round) while 8x more SMs stream the cache.  One persistent
// kernel over all layers and TMA weight streaming are later work.

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_BLOCK = WARPS;  // one output row per warp
constexpr int CLUSTER = 8;             // blocks per head in decode_attention
constexpr float LN_EPS = 1e-5f;

// Up to three weight segments of seg_rows output rows each: output row r
// uses segment r / seg_rows (q|k|v share one launch).  A null bias is none.
template <typename T>
struct Segments {
  const T* w[3];
  const T* b[3];
  T* out[3];
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// y[r] = epilogue(W[r, :] . h) for r < rows, h = x or LayerNorm(x).
// Epilogue, rounding as decoder_step does: y = round(acc); with a bias
// y = round(y + b); with GELU y = round(gelu(y)); with RESID the output
// holds the residual and y = round(out + y) is written back in place.
template <typename T, bool LN, bool GELU, bool RESID>
__global__ void __launch_bounds__(THREADS)
gemv_kernel(const T* __restrict__ x, int n_in, const T* __restrict__ ln_g,
            const T* __restrict__ ln_b, Segments<T> seg, int seg_rows, int rows) {
  extern __shared__ float4 hs4[];
  float* hs = reinterpret_cast<float*>(hs4);
  __shared__ float red[32];

  for (int i = threadIdx.x; i < n_in; i += THREADS) hs[i] = to_f(x[i]);
  if (LN) {
    __syncthreads();
    float s = 0.f;
    for (int i = threadIdx.x; i < n_in; i += THREADS) s += hs[i];
    const float mean = block_sum(s, red) / n_in;
    float s2 = 0.f;
    for (int i = threadIdx.x; i < n_in; i += THREADS) {
      const float d = hs[i] - mean;
      s2 += d * d;
    }
    const float rstd = rsqrtf(block_sum(s2, red) / n_in + LN_EPS);
    for (int i = threadIdx.x; i < n_in; i += THREADS)
      hs[i] = round_to<T>((hs[i] - mean) * rstd * to_f(ln_g[i]) + to_f(ln_b[i]));
  }
  __syncthreads();

  constexpr int V = Vec16<T>::N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (r < rows) {
    const int s = r / seg_rows, rr = r - s * seg_rows;
    const T* w = seg.w[s] + (size_t)rr * n_in;
    float acc = 0.f;
    // unrolled so that several 16-byte loads of the row are in flight
#pragma unroll 4
    for (int i = lane * V; i < n_in; i += 32 * V) {
      float wv[V];
      load16(w + i, wv);
#pragma unroll
      for (int u = 0; u < V; ++u) acc = fmaf(wv[u], hs[i + u], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      float y = round_to<T>(acc);
      if (seg.b[s] != nullptr) y = round_to<T>(y + to_f(seg.b[s][rr]));
      if (GELU) y = round_to<T>(gelu_erf(y));
      T* out = seg.out[s] + rr;
      if (RESID) y = round_to<T>(to_f(*out) + y);
      *out = from_f<T>(y);
    }
  }
}

// One query (1, D) per head against keys/values stored time-last, (H, D,
// t_cap) with the first n positions valid, plus optionally the new token's
// own key/value (self-attention).  As qkv_attention_kt / decoder_step:
// q * D^-0.25 and k * D^-0.25 each rounded to T, f32 scores, f32 softmax,
// weights rounded to T, f32 PV, output rounded to T.  Grid: a cluster of
// CLUSTER blocks per head, block `rank` taking keys [rank * chunk, ...);
// its scores live in its shared memory (chunk floats), and the cluster
// combines maxima, sums and partial outputs over distributed shared memory
// in rank order (deterministic).
template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* __restrict__ out, int n,
                        int t_cap, float scale) {
  extern __shared__ float4 sc4[];
  float* sc = reinterpret_cast<float*>(sc4);
  __shared__ float qs[HD];
  __shared__ float red[32];
  __shared__ float stat[2];    // this block's max, then its sum
  __shared__ float part[HD];   // this block's share of the output

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / CLUSTER;
  const int chunk = (n + CLUSTER - 1) / CLUSTER;
  const int t0 = rank * chunk, t1 = min(n, t0 + chunk);
  const T* kh = k + (size_t)h * HD * t_cap;
  const T* vh = v + (size_t)h * HD * t_cap;
  if (threadIdx.x < HD) qs[threadIdx.x] = round_to<T>(to_f(q[h * HD + threadIdx.x]) * scale);
  __syncthreads();

  float lmax = -INFINITY;
  for (int t = t0 + threadIdx.x; t < t1; t += THREADS) {
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HD; ++d)
      s = fmaf(qs[d], round_to<T>(to_f(kh[(size_t)d * t_cap + t]) * scale), s);
    sc[t - t0] = s;
    lmax = fmaxf(lmax, s);
  }
  const bool has_new = k_new != nullptr;
  float s_new = -INFINITY;
  if (has_new) {  // every thread computes it, in one order: no broadcast needed
    s_new = 0.f;
    for (int d = 0; d < HD; ++d)
      s_new = fmaf(qs[d], round_to<T>(to_f(k_new[h * HD + d]) * scale), s_new);
  }
  lmax = block_max(lmax, red);
  if (threadIdx.x == 0) stat[0] = lmax;
  cluster.sync();
  float m = s_new;
  for (int r = 0; r < CLUSTER; ++r) m = fmaxf(m, *cluster.map_shared_rank(&stat[0], r));

  float lsum = 0.f;
  for (int t = t0 + threadIdx.x; t < t1; t += THREADS) {
    const float p = expf(sc[t - t0] - m);
    sc[t - t0] = p;
    lsum += p;
  }
  lsum = block_sum(lsum, red);
  if (threadIdx.x == 0) stat[1] = lsum;
  cluster.sync();
  const float p_new = has_new ? expf(s_new - m) : 0.f;
  float denom = 0.f;
  for (int r = 0; r < CLUSTER; ++r) denom += *cluster.map_shared_rank(&stat[1], r);
  denom += p_new;
  for (int t = t0 + threadIdx.x; t < t1; t += THREADS)
    sc[t - t0] = round_to<T>(sc[t - t0] / denom);
  __syncthreads();

  // PV: warp w owns rows d = w + WARPS * j; its lanes walk the chunk's
  // keys and keep one accumulator per row, so the rows' loads overlap
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ROWS = HD / WARPS;
  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) acc[j] = 0.f;
  for (int t = t0 + lane; t < t1; t += 32) {
    const float w = sc[t - t0];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
      acc[j] = fmaf(w, to_f(vh[(size_t)(warp + WARPS * j) * t_cap + t]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) part[warp + WARPS * j] = s;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < HD) {
    const int d = threadIdx.x;
    float acc = 0.f;
    for (int r = 0; r < CLUSTER; ++r) acc += *cluster.map_shared_rank(&part[d], r);
    if (has_new) acc = fmaf(round_to<T>(p_new / denom), to_f(v_new[h * HD + d]), acc);
    out[h * HD + d] = from_f<T>(acc);
  }
  cluster.sync();  // rank 0 has read every block's part[] before any exits
}

// weight table order: stacked (L, ...) tensors, torch (out, in) layout;
// the same order as whisper_tpu_torch/ops/kernels/fused_step.py WEIGHTS
enum W {
  ATTN_LN_G, ATTN_LN_B, Q_W, Q_B, K_W, V_W, V_B, O_W, O_B,
  XATTN_LN_G, XATTN_LN_B, XQ_W, XQ_B, XO_W, XO_B,
  MLP_LN_G, MLP_LN_B, FC1_W, FC1_B, FC2_W, FC2_B, N_WEIGHTS
};

template <typename T, bool LN, bool GELU, bool RESID>
void gemv(const T* x, int n_in, const T* g, const T* b, Segments<T> seg,
          int seg_rows, int rows, cudaStream_t stream) {
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  gemv_kernel<T, LN, GELU, RESID>
      <<<blocks, THREADS, n_in * sizeof(float), stream>>>(x, n_in, g, b, seg, seg_rows, rows);
}

template <typename T>
int run(int L, int C, int H, int t_cap, int t, int ta, const void* x_, void* out_,
        void* k_new_, void* v_new_, const void* self_k_, const void* self_v_,
        const void* cross_k_, const void* cross_v_, const void* const* table,
        void* scratch_, cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  T* k_new = static_cast<T*>(k_new_);
  T* v_new = static_cast<T*>(v_new_);
  const T* self_k = static_cast<const T*>(self_k_);
  const T* self_v = static_cast<const T*>(self_v_);
  const T* cross_k = static_cast<const T*>(cross_k_);
  const T* cross_v = static_cast<const T*>(cross_v_);
  T* q = static_cast<T*>(scratch_);  // (C): q (self, then cross)
  T* attn = q + C;                   // (C): attention output, merged heads
  T* ff = attn + C;                  // (4C): fc1 + GELU output

  const float scale = (float)pow((double)HD, -0.25);
  const size_t cc = (size_t)C * C, self_l = (size_t)H * HD * t_cap, cross_l = (size_t)H * HD * ta;
  // each block of a head's cluster holds its chunk of the scores
  const size_t self_smem = (size_t)((t + CLUSTER - 1) / CLUSTER + 1) * sizeof(float);
  const size_t cross_smem = (size_t)((ta + CLUSTER - 1) / CLUSTER) * sizeof(float);

  cudaError_t e = cudaMemcpyAsync(out, x, C * sizeof(T), cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  for (int l = 0; l < L; ++l) {
    auto p = [&](W i, size_t per_layer) {
      return static_cast<const T*>(table[i]) + l * per_layer;
    };
    T* kn = k_new + (size_t)l * C;
    T* vn = v_new + (size_t)l * C;

    Segments<T> s_qkv = {{p(Q_W, cc), p(K_W, cc), p(V_W, cc)},
                         {p(Q_B, C), nullptr, p(V_B, C)},
                         {q, kn, vn}};
    gemv<T, true, false, false>(out, C, p(ATTN_LN_G, C), p(ATTN_LN_B, C), s_qkv, C, 3 * C, stream);
    decode_attention_kernel<T><<<H * CLUSTER, THREADS, self_smem, stream>>>(
        q, self_k + l * self_l, self_v + l * self_l, kn, vn, attn, t, t_cap, scale);
    Segments<T> s_o = {{p(O_W, cc)}, {p(O_B, C)}, {out}};
    gemv<T, false, false, true>(attn, C, nullptr, nullptr, s_o, C, C, stream);

    Segments<T> s_xq = {{p(XQ_W, cc)}, {p(XQ_B, C)}, {q}};
    gemv<T, true, false, false>(out, C, p(XATTN_LN_G, C), p(XATTN_LN_B, C), s_xq, C, C, stream);
    decode_attention_kernel<T><<<H * CLUSTER, THREADS, cross_smem, stream>>>(
        q, cross_k + l * cross_l, cross_v + l * cross_l, nullptr, nullptr, attn, ta, ta, scale);
    Segments<T> s_xo = {{p(XO_W, cc)}, {p(XO_B, C)}, {out}};
    gemv<T, false, false, true>(attn, C, nullptr, nullptr, s_xo, C, C, stream);

    Segments<T> s_fc1 = {{p(FC1_W, 4 * cc)}, {p(FC1_B, 4 * C)}, {ff}};
    gemv<T, true, true, false>(out, C, p(MLP_LN_G, C), p(MLP_LN_B, C), s_fc1, 4 * C, 4 * C, stream);
    Segments<T> s_fc2 = {{p(FC2_W, 4 * cc)}, {p(FC2_B, C)}, {out}};
    gemv<T, false, false, true>(ff, 4 * C, nullptr, nullptr, s_fc2, C, C, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_decoder_layers(int dtype, int L, int C, int H, int t_cap, int t,
                                    int ta, const void* x, void* out, void* k_new,
                                    void* v_new, const void* self_k, const void* self_v,
                                    const void* cross_k, const void* cross_v,
                                    const void* table, void* scratch, void* stream) {
  // the GEMV's shared input vector is 4C floats (static limit 48 KB)
  if (C != H * HD || C % 8 != 0 || 16 * C > 48 * 1024 || t < 0 || t > t_cap || ta <= 0)
    return (int)cudaErrorInvalidValue;
  const void* const* tab = static_cast<const void* const*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_BF16)
    return run<__nv_bfloat16>(L, C, H, t_cap, t, ta, x, out, k_new, v_new, self_k, self_v,
                              cross_k, cross_v, tab, scratch, s);
  if (dtype == DTYPE_F32)
    return run<float>(L, C, H, t_cap, t, ta, x, out, k_new, v_new, self_k, self_v, cross_k,
                      cross_v, tab, scratch, s);
  return (int)cudaErrorInvalidValue;
}
