// ROI max pooling for Hopper (sm_90a), forward and backward, with a plain
// C interface: built by kernels/build.py with nvcc (no PyTorch header) and
// called through ctypes from kernels/roi_pooling.py.
//
// What it replaces: no TPU kernel. The JAX package computes ROIPooling
// (mxnet_tpu/ops/conv.py:341 _roi_pooling) by masks over the whole feature
// map, one mask per output bin: R*ph*pw*C*H*W compares (1.8e10 at Faster
// R-CNN's test shape) and a 240 MB mask an ROI at 512 channels on a 38x63
// map. Its "planned fast path" Pallas kernel was never written.
//
// * mx_roi_pool_fwd: one thread per (roi, c, iy, ix). The bin is computed
//   as the JAX op computes it: x1 = round(roi * scale) half to even
//   (rintf), rh = max(y2 - y1 + 1, 1), bin_h = rh / ph, hstart =
//   floor(y1 + iy * bin_h), hend = ceil(y1 + (iy + 1) * bin_h), each with
//   one float32 rounding (the _rn intrinsics: no fma contraction moves a
//   floor at a bin edge that lands on an integer). It writes the bin's max
//   (0 for an empty bin) and the number of the bin's positions equal to it.
// * mx_roi_pool_bwd: one thread per input element (n, c, y, x). It walks
//   the ROIs of image n in index order and, in each, the bins that contain
//   (y, x); where the input equals the bin's output it adds g / count. That
//   is the VJP of jnp.max, which splits the head gradient equally among
//   every position equal to the max (post-ReLU maps are full of zero
//   ties). No atomics, so repeats are bit for bit.
//
// Bound: bytes for the forward at these sizes (the map is read once from
// device memory, bins overlap in cache), the ROI walk's operations for the
// backward (every element visits every ROI's bounds).
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;   // the JAX op's fill outside a bin

struct Dims {
  int N, C, H, W, R, ph, pw;
  float scale;
};

// An ROI's image and bin grid, rounded as the JAX op rounds them.
struct Roi {
  int b;
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ Roi load_roi(const float* r, const Dims& d) {
  Roi o;
  o.b = min(max(static_cast<int>(r[0]), 0), d.N - 1);
  o.x1 = rintf(__fmul_rn(r[1], d.scale));
  o.y1 = rintf(__fmul_rn(r[2], d.scale));
  const float x2 = rintf(__fmul_rn(r[3], d.scale));
  const float y2 = rintf(__fmul_rn(r[4], d.scale));
  const float rh = fmaxf(__fadd_rn(__fsub_rn(y2, o.y1), 1.0f), 1.0f);
  const float rw = fmaxf(__fadd_rn(__fsub_rn(x2, o.x1), 1.0f), 1.0f);
  o.bin_h = __fdiv_rn(rh, static_cast<float>(d.ph));
  o.bin_w = __fdiv_rn(rw, static_cast<float>(d.pw));
  return o;
}

// [start, end) of bin i of an axis that starts at z1 with bins of `bin`.
__device__ __forceinline__ float bin_start(float z1, int i, float bin) {
  return floorf(__fadd_rn(z1, __fmul_rn(static_cast<float>(i), bin)));
}
__device__ __forceinline__ float bin_end(float z1, int i, float bin) {
  return ceilf(__fadd_rn(z1, __fmul_rn(static_cast<float>(i + 1), bin)));
}

__device__ __forceinline__ int clamp_to(float v, int hi) {
  return static_cast<int>(fminf(fmaxf(v, 0.0f), static_cast<float>(hi)));
}

__global__ void __launch_bounds__(kThreads)
    roi_pool_fwd_kernel(const float* __restrict__ data,
                        const float* __restrict__ rois,
                        float* __restrict__ out, int* __restrict__ count,
                        Dims d) {
  const long long total = static_cast<long long>(d.R) * d.C * d.ph * d.pw;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int ix = static_cast<int>(idx % d.pw);
    const int iy = static_cast<int>((idx / d.pw) % d.ph);
    const int c = static_cast<int>((idx / (d.pw * d.ph)) % d.C);
    const int r = static_cast<int>(idx / (static_cast<long long>(d.pw) *
                                          d.ph * d.C));
    const Roi roi = load_roi(rois + 5 * static_cast<size_t>(r), d);
    const int h0 = clamp_to(bin_start(roi.y1, iy, roi.bin_h), d.H);
    const int h1 = clamp_to(bin_end(roi.y1, iy, roi.bin_h), d.H);
    const int w0 = clamp_to(bin_start(roi.x1, ix, roi.bin_w), d.W);
    const int w1 = clamp_to(bin_end(roi.x1, ix, roi.bin_w), d.W);
    if (h0 >= h1 || w0 >= w1) {
      out[idx] = 0.0f;
      count[idx] = 0;
      continue;
    }
    const float* p =
        data + (static_cast<size_t>(roi.b) * d.C + c) * d.H * d.W;
    float m = kNeg;
    for (int y = h0; y < h1; ++y)
      for (int x = w0; x < w1; ++x) {
        const float v = p[y * d.W + x];
        if (v > m || v != v) m = v;
      }
    int n = 0;
    for (int y = h0; y < h1; ++y)
      for (int x = w0; x < w1; ++x) n += p[y * d.W + x] == m;
    out[idx] = m;
    count[idx] = n;
  }
}

__global__ void __launch_bounds__(kThreads)
    roi_pool_bwd_kernel(const float* __restrict__ grad,
                        const float* __restrict__ data,
                        const float* __restrict__ rois,
                        const float* __restrict__ out,
                        const int* __restrict__ count,
                        float* __restrict__ dx, Dims d) {
  const long long total = static_cast<long long>(d.N) * d.C * d.H * d.W;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int x = static_cast<int>(idx % d.W);
    const int y = static_cast<int>((idx / d.W) % d.H);
    const int c = static_cast<int>((idx / (static_cast<long long>(d.W) *
                                           d.H)) % d.C);
    const int n = static_cast<int>(idx / (static_cast<long long>(d.W) *
                                          d.H * d.C));
    const float v = data[idx];
    const float fy = static_cast<float>(y), fx = static_cast<float>(x);
    float acc = 0.0f;
    for (int r = 0; r < d.R; ++r) {
      const Roi roi = load_roi(rois + 5 * static_cast<size_t>(r), d);
      if (roi.b != n) continue;
      for (int iy = 0; iy < d.ph; ++iy) {
        if (!(fy >= bin_start(roi.y1, iy, roi.bin_h) &&
              fy < bin_end(roi.y1, iy, roi.bin_h)))
          continue;
        for (int ix = 0; ix < d.pw; ++ix) {
          if (!(fx >= bin_start(roi.x1, ix, roi.bin_w) &&
                fx < bin_end(roi.x1, ix, roi.bin_w)))
            continue;
          const size_t o =
              ((static_cast<size_t>(r) * d.C + c) * d.ph + iy) * d.pw + ix;
          const int k = count[o];
          if (k > 0 && v == out[o])
            acc = __fadd_rn(acc, __fdiv_rn(grad[o], static_cast<float>(k)));
        }
      }
    }
    dx[idx] = acc;
  }
}

int blocks_for(long long total) {
  const long long b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < (1 << 20) ? b : (1 << 20));
}

}  // namespace

// The forward of ROIPooling: data (N, C, H, W) and rois (R, 5) float32
// [batch, x1, y1, x2, y2] in image coordinates; out (R, C, ph, pw) float32
// and count (R, C, ph, pw) int32. Returns the launch's cudaError_t.
extern "C" int mx_roi_pool_fwd(const float* data, const float* rois,
                               float* out, int* count, int N, int C, int H,
                               int W, int R, int ph, int pw, float scale,
                               int device, void* stream) {
  const Dims d{N, C, H, W, R, ph, pw, scale};
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || ph <= 0 || pw <= 0)
    return cudaErrorInvalidValue;
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  roi_pool_fwd_kernel<<<blocks_for(static_cast<long long>(R) * C * ph * pw),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, rois, out, count, d);
  return static_cast<int>(cudaGetLastError());
}

// The input gradient of ROIPooling from the head gradient and the
// forward's out and count: dx (N, C, H, W) float32.
extern "C" int mx_roi_pool_bwd(const float* grad, const float* data,
                               const float* rois, const float* out,
                               const int* count, float* dx, int N, int C,
                               int H, int W, int R, int ph, int pw,
                               float scale, int device, void* stream) {
  const Dims d{N, C, H, W, R, ph, pw, scale};
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || R <= 0 || ph <= 0 || pw <= 0)
    return cudaErrorInvalidValue;
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  roi_pool_bwd_kernel<<<blocks_for(static_cast<long long>(N) * C * H * W),
                        kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, data, rois, out, count, dx, d);
  return static_cast<int>(cudaGetLastError());
}
