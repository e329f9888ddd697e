// Greedy non-maximum suppression for Hopper (sm_90a), with a plain C
// interface: built by kernels/build.py with nvcc (no PyTorch header) and
// called through ctypes from kernels/nms.py.
//
// What it replaces: no TPU kernel. The JAX package left NMS to XLA
// (mxnet_tpu/ops/detection.py:114 _nms_suppress, with its IoU from :21
// _iou_matrix): a dense N x N IoU matrix and a fori_loop of N dependent
// steps. In eager PyTorch that loop is ~3 launches a step, ~26,000 an image
// at SSD300's 8,732 anchors; these two kernels take one launch each for a
// whole batch.
//
// * mx_nms_mask: boxes already sorted by score, (B, N, 4) corner format.
//   Block (cb, rb, b) holds the 64 boxes of column tile cb in shared memory;
//   thread i takes row rb*64 + i and writes one 64-bit word whose bit j says
//   iou(row, cb*64 + j) > thresh for cb*64 + j > row. N * ceil(N/64) words
//   an image; words left of the diagonal are written as 0.
// * mx_nms_scan: one block per image walks the sorted order 64 boxes at a
//   time. The removed bits live in shared memory. Thread 0 settles a tile
//   on its own from the tile's diagonal words (kept iff its bit is clear;
//   a kept box ORs its word in), then all threads OR the kept boxes' words
//   into every later tile's removed word. keep[i] = 1 iff box i was not
//   removed: the greedy rule of the JAX loop (box i suppresses j > i iff i
//   is kept and iou > thresh).
//
// Bound: operations in the mask (one IoU per pair above the diagonal, 14
// float32 operations, and 4 a box for its area), latency in the scan (a
// dependent walk per image).
//
// Rounding: every line of the IoU rounds as _iou_matrix's float32 ops do,
// in the same order: the _rn intrinsics keep nvcc from contracting
// (area_a + area_b) - iw*ih or any product and sum into an fma, and the
// division is IEEE (no fast math), so a pair at the threshold decides as
// it does in the JAX package. Deterministic: no atomics; every word is
// written by one thread.
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kBits = 64;
constexpr int kScanThreads = 256;
constexpr int kMaxScanWords = 48 * 1024 / 8;   // default dynamic smem

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3]};
}

// _iou_matrix's lines, one rounding each, in its order.
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float ix1 = fmaxf(a.x1, b.x1);
  const float iy1 = fmaxf(a.y1, b.y1);
  const float ix2 = fminf(a.x2, b.x2);
  const float iy2 = fminf(a.y2, b.y2);
  const float iw = fmaxf(__fsub_rn(ix2, ix1), 0.0f);
  const float ih = fmaxf(__fsub_rn(iy2, iy1), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float area_a =
      fmaxf(__fmul_rn(__fsub_rn(a.x2, a.x1), __fsub_rn(a.y2, a.y1)), 0.0f);
  const float area_b =
      fmaxf(__fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1)), 0.0f);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void __launch_bounds__(kBits)
    nms_mask_kernel(const float* __restrict__ boxes,
                    unsigned long long* __restrict__ mask, int n, int words,
                    float thresh) {
  __shared__ Box cols[kBits];
  const int cb = blockIdx.x, rb = blockIdx.y;
  const float* img = boxes + static_cast<size_t>(blockIdx.z) * n * 4;
  const int col0 = cb * kBits;
  const int ncols = min(kBits, n - col0);
  if (static_cast<int>(threadIdx.x) < ncols)
    cols[threadIdx.x] = load_box(img + 4 * (col0 + threadIdx.x));
  __syncthreads();
  const int row = rb * kBits + threadIdx.x;
  if (row >= n) return;
  unsigned long long bits = 0;
  if (cb >= rb) {
    const Box me = load_box(img + 4 * row);
    for (int j = cb == rb ? threadIdx.x + 1 : 0; j < ncols; ++j)
      if (iou(me, cols[j]) > thresh) bits |= 1ull << j;
  }
  mask[(static_cast<size_t>(blockIdx.z) * n + row) * words + cb] = bits;
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    bool* __restrict__ keep, int n, int words) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[kBits];
  __shared__ int kept[kBits];
  __shared__ int nkept;
  const unsigned long long* m =
      mask + static_cast<size_t>(blockIdx.x) * n * words;
  bool* k = keep + static_cast<size_t>(blockIdx.x) * n;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0;
  __syncthreads();
  for (int w = 0; w < words; ++w) {
    const int base = w * kBits;
    const int cnt = min(kBits, n - base);
    if (static_cast<int>(threadIdx.x) < cnt)
      diag[threadIdx.x] =
          m[static_cast<size_t>(base + threadIdx.x) * words + w];
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rem = removed[w];
      int nk = 0;
      for (int j = 0; j < cnt; ++j) {
        if (!((rem >> j) & 1ull)) {
          kept[nk++] = base + j;
          rem |= diag[j];
        }
      }
      removed[w] = rem;
      nkept = nk;
    }
    __syncthreads();
    const unsigned long long rem = removed[w];
    for (int j = threadIdx.x; j < cnt; j += blockDim.x)
      k[base + j] = !((rem >> j) & 1ull);
    const int nk = nkept;
    for (int t = w + 1 + threadIdx.x; t < words; t += blockDim.x) {
      unsigned long long acc = removed[t];
      for (int i = 0; i < nk; ++i)
        acc |= m[static_cast<size_t>(kept[i]) * words + t];
      removed[t] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// The suppression words of `batch` images of n score-sorted boxes each:
// boxes (batch, n, 4) float32, mask (batch, n, ceil(n/64)) 64-bit words.
// Returns the launch's cudaError_t, 0 on success.
extern "C" int mx_nms_mask(const float* boxes, unsigned long long* mask,
                           int batch, int n, float thresh, int device,
                           void* stream) {
  if (batch <= 0 || n <= 0 || batch > 65535) return cudaErrorInvalidValue;
  const int words = (n + kBits - 1) / kBits;
  if (words > 65535) return cudaErrorInvalidValue;
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  nms_mask_kernel<<<dim3(words, words, batch), kBits, 0,
                    static_cast<cudaStream_t>(stream)>>>(boxes, mask, n,
                                                         words, thresh);
  return static_cast<int>(cudaGetLastError());
}

// The keep flags (batch, n) of the greedy walk over mx_nms_mask's words.
extern "C" int mx_nms_scan(const unsigned long long* mask, bool* keep,
                           int batch, int n, int device, void* stream) {
  const int words = (n + kBits - 1) / kBits;
  if (batch <= 0 || n <= 0 || words > kMaxScanWords)
    return cudaErrorInvalidValue;
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  nms_scan_kernel<<<batch, kScanThreads, words * sizeof(unsigned long long),
                    static_cast<cudaStream_t>(stream)>>>(mask, keep, n,
                                                         words);
  return static_cast<int>(cudaGetLastError());
}
