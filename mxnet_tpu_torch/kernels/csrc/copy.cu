// Pure copy of a contiguous buffer for Hopper (sm_90a), with a plain C
// interface: built by kernels/copy.py through
// torch.utils.cpp_extension.load (no PyTorch header is included, so nvcc
// compiles this file alone) and called through ctypes.
//
// Replaces the TPU kernel k_copy of tools/bn_pallas_probe.py (copy_sweep,
// pallas_call at :331), which copied column blocks of a (128, 256*3136)
// bf16 array through VMEM to measure the block-DMA ceiling.
//
// Bound: bytes. Every byte is read once and written once; no arithmetic.
// Design: each thread moves VPT 16-byte vectors (uint4) per iteration,
// with neighbouring threads on neighbouring vectors, so a warp's loads
// and stores are whole 512-byte runs; all VPT loads issue before the
// first store, so VPT sets the bytes in flight per thread (the probe
// sweeps 16, 64 and 256 bytes). One tile of THREADS * VPT vectors per
// block. The n_bytes % 16 bytes past the last whole vector are copied
// byte by byte by the first threads of block 0.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int VPT>
__global__ void __launch_bounds__(kThreads)
copy_vec(const uint4* __restrict__ src, uint4* __restrict__ dst,
         long long n_vec, const unsigned char* __restrict__ src_tail,
         unsigned char* __restrict__ dst_tail, int n_tail) {
  const long long base =
      static_cast<long long>(blockIdx.x) * (kThreads * VPT) + threadIdx.x;
  uint4 r[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n_vec) r[i] = __ldg(src + j);
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const long long j = base + static_cast<long long>(i) * kThreads;
    if (j < n_vec) dst[j] = r[i];
  }
  if (blockIdx.x == 0 && static_cast<int>(threadIdx.x) < n_tail) {
    dst_tail[threadIdx.x] = src_tail[threadIdx.x];
  }
}

template <int VPT>
cudaError_t launch(const void* src, void* dst, long long n_bytes,
                   long long grid, cudaStream_t stream) {
  const long long n_vec = n_bytes / 16;
  const int n_tail = static_cast<int>(n_bytes - n_vec * 16);
  copy_vec<VPT><<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec,
      static_cast<const unsigned char*>(src) + n_vec * 16,
      static_cast<unsigned char*>(dst) + n_vec * 16, n_tail);
  return cudaGetLastError();
}

}  // namespace

// Copies n_bytes from src to dst (both 16-byte aligned) on `stream` with
// `grid` blocks of 256 threads, each thread moving `vpt` (1, 4 or 16)
// vectors. Returns the launch's cudaError_t (0 on success); an unknown
// vpt returns cudaErrorInvalidValue without launching.
extern "C" int mx_copy(const void* src, void* dst, long long n_bytes,
                       int vpt, long long grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vpt) {
    case 1: return static_cast<int>(launch<1>(src, dst, n_bytes, grid, s));
    case 4: return static_cast<int>(launch<4>(src, dst, n_bytes, grid, s));
    case 16: return static_cast<int>(launch<16>(src, dst, n_bytes, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
