// Shared helpers for the port's hand-written Hopper kernels.
//
// Element types: the kernels are templated on the storage type T, float or
// __nv_bfloat16 (int8_t for quantized weights and K/V), and compute in
// float.  to_f / from_f convert with
// round-to-nearest-even, the rounding torch and XLA use, so "round to the
// compute dtype" in a kernel is from_f then to_f.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <unordered_map>

enum DType : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }  // int8 storage: exact

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the value a T-typed intermediate would hold
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// One 16-byte vector load of T elements converted to float: 4 floats or 8
// bf16 values.  p must be 16-byte aligned.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load16(const float* __restrict__ p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* __restrict__ p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions for blockDim.x a multiple of 32 (<= 1024).  `red`
// is shared scratch of at least 32 floats; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nwarps; ++w) r += red[w];
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = -INFINITY;
  for (int w = 0; w < nwarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

// Programmatic dependent launch (Hopper): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// launch before it on the stream still runs.  Until pdl_wait() it may only
// read what that launch does not write (weights, caches); pdl_wait()
// returns once the launch before it has completed and its writes are
// visible (a no-op in a kernel launched without the attribute), and
// pdl_trigger() lets the next launch start once every block of this one
// has called it (or exited).
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void pdl_trigger() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }

// `bytes` (a multiple of 16) from global address p (16-byte aligned) into
// the L2 cache, asynchronously, without a register or a barrier
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// Raise a kernel's dynamic shared-memory allowance to `smem` bytes where it
// is lower (the runtime refuses a launch whose static and dynamic shared
// memory pass 48 KB without it), once per kernel and size: the attribute
// lasts for the device context, and the port drives one card.
inline cudaError_t allow_smem(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> allowed;
  std::lock_guard<std::mutex> lock(mu);
  size_t& cur = allowed[kernel];
  if (smem <= cur) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) cur = smem;
  return e;
}

// A chain of launches on one stream: every launch after the first carries
// the programmatic-serialization attribute (its kernels call pdl_wait()
// before they read an earlier launch's output), so its blocks start while
// the launch before it drains; the first waits for the stream as any
// launch does.  cluster > 0 adds a (cluster, 1, 1) thread-block cluster.
// The first error is kept in err.
struct Chain {
  cudaStream_t stream;
  bool pdl = false;
  cudaError_t err = cudaSuccess;

  explicit Chain(cudaStream_t s) : stream(s) {}

  template <typename... KArgs, typename... Args>
  void launch(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem, int cluster, Args... args) {
    cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    cudaLaunchAttribute attr[2];
    int n = 0;
    if (pdl) {
      attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[n++].val.programmaticStreamSerializationAllowed = 1;
    }
    if (cluster > 0) {
      attr[n].id = cudaLaunchAttributeClusterDimension;
      attr[n].val.clusterDim.x = (unsigned)cluster;
      attr[n].val.clusterDim.y = 1;
      attr[n++].val.clusterDim.z = 1;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = (unsigned)n;
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
    if (err == cudaSuccess) err = e;
    pdl = true;
  }

  // an error found before a launch (that launch is not made)
  void fail(cudaError_t e) {
    if (err == cudaSuccess) err = e;
  }

  // the chain's error, or a launch error the runtime recorded
  int result() const { return (int)(err != cudaSuccess ? err : cudaGetLastError()); }
};
