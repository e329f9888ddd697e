// Pure copy of a contiguous buffer for Hopper (sm_90a) on the port's
// streaming engine (stream.cuh), with a plain C interface: built by
// kernels/build.py with nvcc and called by kernels/copy.py through ctypes.
//
// Replaces the TPU kernel k_copy of tools/bn_pallas_probe.py (copy_sweep,
// pallas_call at :331), which copied column blocks of a (128, 256*3136)
// bf16 array through VMEM to measure the block-DMA ceiling.
//
// Bound: bytes. Every byte is read once and written once; no arithmetic.
// Design: the engine's pass over 16-byte vectors (uint4) with streaming
// loads and stores; each thread moves `unroll` vectors a round, all loads
// before the first store, so `unroll` sets the bytes in flight per thread
// (the probe sweeps 1, 4 and 16 vectors). The n % 16 bytes past the last
// whole vector are copied byte by byte by the last block's first threads.
#include "stream.cuh"

// Copies n_bytes from src to dst (both 16-byte aligned, on `device`) on
// `stream` as the packed plan (kernels/stream.py) says. Returns the
// launch's cudaError_t (0 on success); a plan that does not fit returns
// cudaErrorInvalidValue without launching.
extern "C" int mx_copy(const void* src, void* dst, long long n_bytes,
                       const long long* plan, int device, void* stream) {
  return mxstream::launch_copy(src, dst, n_bytes, plan, device, stream);
}
