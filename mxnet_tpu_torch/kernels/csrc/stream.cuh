// Streaming engine for Hopper (sm_90a): one pass over contiguous arrays
// that maps an elementwise function over n_in float inputs into n_out
// float outputs (an mx.rtc body), or copies bytes (the copy probe).
// Header only; kernels/stream.py plans every launch, and a source that
// includes this header instantiates it: csrc/copy.cu, and the CUDA that
// kernels/rtc_codegen.py generates from each rtc body.
//
// Bound: bytes. Every input byte is read once and every output byte
// written once, with a few operations per element at most, far below the
// card's ~295 operations per byte. So the design keeps device memory busy
// with 16-byte accesses and enough of them in flight:
//
// * Vectors. The body is cut into 16-byte vectors (4 floats, or 16 bytes
//   for copy) and the vectors into tiles of threads x `unroll`. Block b
//   takes tiles b, b + gridDim.x, ... (the plan's grid gives each block
//   one); thread t moves vectors t, t + threads, ... of a tile, every load
//   before its first store, so a thread keeps `unroll` vectors of every
//   input in flight, a warp's accesses are whole 512-byte runs and a
//   block's one contiguous stretch. Loads and stores take the default
//   caching. On an H100 (700 W), vectors a grid's width apart in one
//   thread ran a copy of 16 vectors a thread at half speed, and streaming
//   hints (ld/st.global.cs) cost 1.3-2.6% on four of six kernels and
//   gained 1.1% on one (tools/stream_ab.py; PERF.md, section 6).
// * Alignment. Vectors are aligned to the first output: the `head`
//   elements before its first 16-byte boundary and the `tail` after the
//   last whole vector move one by one (the last block's first threads do
//   them). A ref whose own address is aligned at the first output's
//   vectors (bit r of vec_mask, inputs first) moves as one 16-byte
//   access, any other as four 4-byte words. Copy buffers are 16-byte
//   aligned: no head, every vector whole.
// * Devices. The C entries take the device of the refs, make it current
//   for the launch and restore the caller's device.
//
// A bulk plan (cp.async.bulk into a ring of shared-memory stages on an
// mbarrier, results by bulk stores) measured no faster for rtc and 1.2-
// 1.6% slower for copy on an H100 (PERF.md, section 6): not kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace mxstream {
// Internal linkage: each library that includes the header keeps its own
// kernels, whatever else the process has loaded.
namespace {

// Threads per block. Also the launch bound: a copy of 16 vectors per
// thread needs more than the 64 registers a bound of 1024 leaves, and
// spilled to run at half speed on an H100.
constexpr int kThreads = 256;

// The plan as kernels/stream.py packs it: 7 int64 in Plan._fields order.
// Counts are in elements (floats for rtc, bytes for copy); vector v covers
// elements [head + 4 v, head + 4 v + 4) of a float pass and bytes
// [16 v, 16 v + 16) of a copy.
struct Plan {
  long long head, body, tail, vectors, unroll, grid, vec_mask;
};

template <int kIn, int kOut>
struct Refs {
  const float* in[kIn];
  float* out[kOut];
};

// The head and tail elements of an rtc pass, by the last block's first
// threads.
template <class Body>
__device__ __forceinline__ void rtc_edges(const Refs<Body::kIn, Body::kOut>& r,
                                          const Plan& p) {
  if (blockIdx.x != gridDim.x - 1) return;
  const long long i = threadIdx.x;
  if (i >= p.head + p.tail) return;
  const long long e = i < p.head ? i : p.body + i;   // head + body + (i - head)
  float a[Body::kIn], o[Body::kOut];
#pragma unroll
  for (int j = 0; j < Body::kIn; ++j) a[j] = r.in[j][e];
  Body::apply(a, o);
#pragma unroll
  for (int j = 0; j < Body::kOut; ++j) r.out[j][e] = o[j];
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// rtc: the body over 4-float vectors
// ---------------------------------------------------------------------------
template <class Body, int kUnroll>
__global__ void __launch_bounds__(kThreads)
    rtc_stream(Refs<Body::kIn, Body::kOut> r, Plan p) {
  constexpr int kIn = Body::kIn, kOut = Body::kOut;
  rtc_edges<Body>(r, p);
  const long long nvec = p.vectors;
  const long long tile = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < nvec;
       base += gridDim.x * tile) {
    float4 v[kUnroll][kIn];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = p.head + 4 * (base + u * blockDim.x);
      if (base + u * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < kIn; ++j)
          v[u][j] = load4(r.in[j] + e, (p.vec_mask >> j) & 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = p.head + 4 * (base + u * blockDim.x);
      if (base + u * blockDim.x >= nvec) continue;
      float4 w[kOut];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float a[kIn], o[kOut];
#pragma unroll
        for (int j = 0; j < kIn; ++j)
          a[j] = reinterpret_cast<float*>(&v[u][j])[q];
        Body::apply(a, o);
#pragma unroll
        for (int j = 0; j < kOut; ++j) reinterpret_cast<float*>(&w[j])[q] = o[j];
      }
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        store4(r.out[j] + e, w[j], (p.vec_mask >> (kIn + j)) & 1);
    }
  }
}

// ---------------------------------------------------------------------------
// Copy: 16-byte vectors straight back
// ---------------------------------------------------------------------------
template <int kUnroll>
__global__ void __launch_bounds__(kThreads)
    copy_stream(const unsigned char* src, unsigned char* dst, Plan p) {
  // the tail bytes, by the last block's first threads
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < p.tail)
    dst[p.body + threadIdx.x] = src[p.body + threadIdx.x];
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const long long nvec = p.vectors;
  const long long tile = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = blockIdx.x * tile + threadIdx.x; base < nvec;
       base += gridDim.x * tile) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * blockDim.x;
      if (j < nvec) v[u] = __ldg(s + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = base + u * blockDim.x;
      if (j < nvec) d[j] = v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
// The C entries' device guard (device.cuh).
using mxcuda::DeviceGuard;

inline bool plan_ok(const Plan& p, long long n) {
  return p.head + p.body + p.tail == n && p.grid >= 1 &&
         p.head + p.tail <= kThreads;
}

// The rtc passes' vectors in flight per thread.
constexpr int kRtcUnroll = 2;

// Launch the rtc pass of `Body` over n elements on `stream` of `device`
// as `plan` says; returns the launch's cudaError_t (cudaErrorInvalidValue,
// without launching, for a plan that does not fit n).
template <class Body>
int launch_rtc(const float* const* ins, float* const* outs, long long n,
               const long long* plan, int device, void* stream) {
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  if (!plan_ok(p, n) || p.unroll != kRtcUnroll || p.body != 4 * p.vectors)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  Refs<Body::kIn, Body::kOut> r;
  for (int j = 0; j < Body::kIn; ++j) r.in[j] = ins[j];
  for (int j = 0; j < Body::kOut; ++j) r.out[j] = outs[j];
  rtc_stream<Body, kRtcUnroll><<<static_cast<unsigned>(p.grid), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(r, p);
  return static_cast<int>(cudaGetLastError());
}

// Launch the copy of n bytes (both buffers 16-byte aligned) on `stream`
// of `device`, with 1, 4 or 16 vectors in flight per thread (`unroll`).
inline int launch_copy(const void* src, void* dst, long long n,
                       const long long* plan, int device, void* stream) {
  const Plan& p = *reinterpret_cast<const Plan*>(plan);
  if (!plan_ok(p, n) || p.head != 0 || p.body != 16 * p.vectors)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const dim3 grid(static_cast<unsigned>(p.grid)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const unsigned char*>(src);
  auto* b = static_cast<unsigned char*>(dst);
  switch (p.unroll) {
    case 1: copy_stream<1><<<grid, block, 0, s>>>(a, b, p); break;
    case 4: copy_stream<4><<<grid, block, 0, s>>>(a, b, p); break;
    case 16: copy_stream<16><<<grid, block, 0, s>>>(a, b, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mxstream
