// BatchNorm(+ReLU) train core for Hopper (sm_90a), with a plain C
// interface: built by kernels/batchnorm.py through
// torch.utils.cpp_extension.load (no PyTorch header is included, so nvcc
// compiles this file alone) and called through ctypes.
//
// What it replaces:
// * mx_bn_bwd is the counterpart of the TPU kernel bn_bwd_onepass
//   (tools/bn_pallas_probe.py:76, pallas_call at :142) and of the jnp
//   hand-VJP backward _bwd (mxnet_tpu/ops/nn.py:519): dv = du masked by the
//   ReLU recomputed as fma(x, scale, shift) > 0, x^ = (x - mean) * rstd,
//   dbeta = sum dv, dgamma = sum dv * x^, dx = (dv - dbeta/n - x^ dgamma/n)
//   * scale.
// * mx_bn_fwd is the counterpart of the jnp forward _fwd
//   (mxnet_tpu/ops/nn.py:460): centred one-pass statistics about c
//   (m1 = sum(x - c)/n, m2 = sum(x - c)^2/n, mean = c + m1,
//   var = max(m2 - m1^2, 0)), or two-pass mean-then-var under `exact`;
//   rstd, scale, shift; y = fma(x, scale, shift) and the optional ReLU.
// * mx_bn_fwd_partials, mx_bn_fwd_apply, mx_bn_bwd_partials and
//   mx_bn_bwd_dx are the cross-rank form of the same pair: under a dp mesh
//   the JAX package reduces the core's moments and backward sums over the
//   global batch (GSPMD inserts the psum). A rank's partial sums (about a
//   centre every rank shares) go out as one (C, 2) float tensor, the
//   caller all-reduces it over the ranks, and the apply kernels finish
//   from the global sums. They run on the split plan's grid, each chunk's
//   partials added in chunk order, so a rank's sums are deterministic too.
//
// Bound: bytes. A few flops per element, far below the card's balance
// point. The least traffic is 2 activation sweeps for the forward (read x,
// write y) and 3 for the backward (read x and du, write dx).
//
// Design: a channel's slab (its N planes of HW contiguous elements) is
// read from device memory once and kept on chip. Three plans, chosen in
// Python (batchnorm.py plan()) by the bytes of one channel's slab (x in the
// forward; x and du in the backward):
// * block: the slab fits one block's shared memory (at most 227 KB less
//   1 KB of scratch): one block per channel, one launch.
// * cluster: the slab fits a cluster of k = 2, 4 or 8 blocks (the portable
//   sizes), each holding a contiguous share. The blocks' partial sums are
//   exchanged through distributed shared memory and every block adds them
//   in rank order 0..k-1, so all hold bit-identical totals. One launch.
// * split: anything larger. A partial-sums kernel writes one fixed slot
//   per (channel, chunk); an apply kernel reduces a channel's slots in a
//   fixed order and makes the elementwise pass (3 sweeps forward, 5
//   backward; a third launch under `exact`).
// In the block and cluster plans the statistics (or dbeta, dgamma) are
// summed while the slab is loaded, and the elementwise pass (and the second
// pass of `exact`) runs from shared memory: 2 sweeps forward, 3 backward.
// Without dx the backward only reduces.
//
// Addressing: a channel is walked in units of UB bytes (16 where a plane's
// bytes and start allow it, else 4 or 2), with each thread's (plane, unit)
// advanced by a fixed quotient and remainder, so no element is divided.
//
// Determinism: every sum runs in an order fixed by the plan alone (per
// thread in unit order, a shuffle tree per warp, warps and then cluster
// ranks or chunks in index order). No atomics, so repeat runs are bit for
// bit identical. Statistics are float32 for bfloat16 x too; y and the
// backward's mask both use __fmaf_rn(x, scale, shift), so the ReLU mask
// never flips between them.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSlabThreads = 1024;            // most threads of a slab block
constexpr int kSplitThreads = 256;
constexpr int kMaxDynSmem = 232448 - 1024;    // 227 KB less static scratch
constexpr int kMaxDevices = 64;
enum Plan { kBlock = 0, kCluster = 1, kSplit = 2 };

template <typename T, int UB>
struct alignas(UB) Unit {
  static constexpr int kVec = UB / static_cast<int>(sizeof(T));
  T v[kVec];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geom {
  int hwu;     // units in one (n, c) plane
  int chwu;    // units in one sample, C * hwu
  int units;   // units of one channel, N * hwu
  int share;   // units a block holds (block, cluster) or a chunk has (split)
  int q, s;    // blockDim.x = q * hwu + s
  float n;     // elements of one channel, N * HW
};

// This thread's units lo + threadIdx.x + i * blockDim.x (below hi) of one
// channel, kU at a time: each one's index from lo (-1 past hi) and its
// offset in units from the channel's first plane.
template <int kU>
struct Cursor {
  int u, n, r;
  __device__ Cursor(const Geom& g, int lo) : u(lo + threadIdx.x) {
    n = u / g.hwu;
    r = u - n * g.hwu;
  }
  __device__ bool more(int hi) const { return u < hi; }
  __device__ void next(const Geom& g, int lo, int hi, int (&idx)[kU],
                       int (&off)[kU]) {
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const bool ok = u < hi;
      idx[j] = ok ? u - lo : -1;
      off[j] = ok ? n * g.chwu + r : 0;
      u += blockDim.x;
      n += g.q;
      r += g.s;
      if (r >= g.hwu) {
        r -= g.hwu;
        ++n;
      }
    }
  }
};

struct Scratch {
  float2 warp[32];   // each warp's sums
  float2 mine[2];    // this block's sums, one slot per round
  float2 total;
};

// The total of (a, b) over the block, or over the cluster of k blocks
// (k > 1), in a fixed order, broadcast to every thread: the same bits in
// every block of a cluster. `round` (0 or 1) gives each reduction of a
// kernel its own slot, so a peer may still read the last one.
__device__ float2 total(float a, float b, Scratch& sh, int k, int round) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) sh.warp[w] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = make_float2(0.f, 0.f);
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
      t.x += sh.warp[i].x;
      t.y += sh.warp[i].y;
    }
    sh.mine[round] = t;
    if (k == 1) sh.total = t;
  }
  if (k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every block's sums are written
    if (threadIdx.x == 0) {
      float2 t = make_float2(0.f, 0.f);
      for (int r = 0; r < k; ++r) {
        const float2* p = cluster.map_shared_rank(&sh.mine[round], r);
        t.x += p->x;
        t.y += p->y;
      }
      sh.total = t;
    }
  }
  __syncthreads();
  const float2 t = sh.total;
  __syncthreads();   // warp and total may be written again
  return t;
}

// The total of a channel's S partial sums, in the same order in every
// block.
__device__ float2 chunk_total(const float2* p, int S, Scratch& sh) {
  float a = 0.f, b = 0.f;
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    a += p[j].x;
    b += p[j].y;
  }
  return total(a, b, sh, 1, 0);
}

// (sum (x - cc), sum (x - cc)^2) of one unit, added to (a, b).
template <typename T, int UB>
__device__ __forceinline__ void add_moments(const Unit<T, UB>& v, float cc,
                                            float& a, float& b) {
#pragma unroll
  for (int e = 0; e < Unit<T, UB>::kVec; ++e) {
    const float d = to_f(v.v[e]) - cc;
    a += d;
    b = __fmaf_rn(d, d, b);
  }
}

struct Affine {
  float mean, var, rstd, scale, shift;
};

__device__ Affine affine(float mean, float var, float eps,
                         const float* gamma, const float* beta, int c,
                         int fix_gamma) {
  Affine f;
  f.mean = mean;
  f.var = var;
  f.rstd = 1.0f / sqrtf(var + eps);
  f.scale = fix_gamma ? f.rstd : __fmul_rn(gamma[c], f.rstd);
  f.shift = __fsub_rn(beta[c], __fmul_rn(mean, f.scale));
  return f;
}

__device__ void write_stats(float* stats, int C, int c, const Affine& f) {
  stats[c] = f.mean;
  stats[C + c] = f.var;
  stats[2 * C + c] = f.rstd;
  stats[3 * C + c] = f.scale;
  stats[4 * C + c] = f.shift;
}

template <typename T, int UB>
__device__ __forceinline__ Unit<T, UB> apply_unit(const Unit<T, UB>& v,
                                                  const Affine& f,
                                                  int relu) {
  Unit<T, UB> o;
#pragma unroll
  for (int e = 0; e < Unit<T, UB>::kVec; ++e) {
    float z = __fmaf_rn(to_f(v.v[e]), f.scale, f.shift);
    if (relu && z < 0.f) z = 0.f;
    o.v[e] = from_f<T>(z);
  }
  return o;
}

// The backward's per-channel inputs.
struct Chan {
  float mu, rs, sc, sh;
  int relu;
  __device__ float masked(float x, float du) const {
    return (relu && !(__fmaf_rn(x, sc, sh) > 0.f)) ? 0.f : du;
  }
};

__device__ Chan chan(const float* mean, const float* rstd,
                     const float* scale, const float* shift, int c,
                     int relu) {
  return Chan{mean[c], rstd[c], scale[c], shift[c], relu};
}

// (sum dv, sum dv * x^) of one unit, added to (a, b).
template <typename T, int UB>
__device__ __forceinline__ void add_grads(const Unit<T, UB>& xv,
                                          const Unit<T, UB>& dv,
                                          const Chan& p, float& a,
                                          float& b) {
#pragma unroll
  for (int e = 0; e < Unit<T, UB>::kVec; ++e) {
    const float x = to_f(xv.v[e]);
    const float d = p.masked(x, to_f(dv.v[e]));
    a += d;
    b = __fmaf_rn(d, (x - p.mu) * p.rs, b);
  }
}

template <typename T, int UB>
__device__ __forceinline__ Unit<T, UB> dx_unit(const Unit<T, UB>& xv,
                                               const Unit<T, UB>& dv,
                                               const Chan& p, float db_n,
                                               float dg_n) {
  Unit<T, UB> o;
#pragma unroll
  for (int e = 0; e < Unit<T, UB>::kVec; ++e) {
    const float x = to_f(xv.v[e]);
    const float d = p.masked(x, to_f(dv.v[e]));
    const float xh = (x - p.mu) * p.rs;
    o.v[e] = from_f<T>((d - db_n - xh * dg_n) * p.sc);
  }
  return o;
}

// ---------------------------------------------------------------------------
// block and cluster plans: grid C * k, cluster (k, 1, 1) when k > 1
// ---------------------------------------------------------------------------
template <typename T, int UB>
__global__ void __launch_bounds__(kSlabThreads)
fwd_slab(const T* __restrict__ x, T* __restrict__ y,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         const float* __restrict__ center, float* __restrict__ stats,
         Geom g, int C, int k, float eps, int fix_gamma, int relu,
         int exact) {
  using U = Unit<T, UB>;
  constexpr int kU = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  U* slab = reinterpret_cast<U*>(smem);
  __shared__ Scratch sh;
  const int c = blockIdx.x / k, rank = blockIdx.x - c * k;
  const int lo = rank * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  U* yc = reinterpret_cast<U*>(y) + c * g.hwu;
  const float cc = exact ? 0.f : center[c];
  float a = 0.f, b = 0.f;
  for (Cursor<kU> cu(g, lo); cu.more(hi);) {
    int idx[kU], off[kU];
    cu.next(g, lo, hi, idx, off);
    U v[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) v[j] = xc[off[j]];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) {
        slab[idx[j]] = v[j];
        add_moments(v[j], cc, a, b);
      }
  }
  const float2 t = total(a, b, sh, k, 0);
  float mean, var;
  if (exact) {
    mean = t.x / g.n;
    a = b = 0.f;
    for (int i = threadIdx.x; i < hi - lo; i += blockDim.x)
      add_moments(slab[i], mean, a, b);
    var = total(a, b, sh, k, 1).y / g.n;
  } else {
    const float m1 = t.x / g.n, m2 = t.y / g.n;
    mean = cc + m1;
    var = fmaxf(m2 - m1 * m1, 0.f);
  }
  const Affine f = affine(mean, var, eps, gamma, beta, c, fix_gamma);
  if (rank == 0 && threadIdx.x == 0) write_stats(stats, C, c, f);
  for (Cursor<1> cu(g, lo); cu.more(hi);) {
    int idx[1], off[1];
    cu.next(g, lo, hi, idx, off);
    yc[off[0]] = apply_unit(slab[idx[0]], f, relu);
  }
  if (k > 1) cg::this_cluster().sync();   // no peer still reads our sums
}

template <typename T, int UB>
__global__ void __launch_bounds__(kSlabThreads)
bwd_slab(const T* __restrict__ du, const T* __restrict__ x,
         T* __restrict__ dx, const float* __restrict__ mean,
         const float* __restrict__ rstd, const float* __restrict__ scale,
         const float* __restrict__ shift, float* __restrict__ grads,
         Geom g, int C, int k, int relu) {
  using U = Unit<T, UB>;
  constexpr int kU = 2;
  extern __shared__ __align__(16) unsigned char smem[];
  U* xs = reinterpret_cast<U*>(smem);
  U* ds = xs + g.share;
  __shared__ Scratch sh;
  const int c = blockIdx.x / k, rank = blockIdx.x - c * k;
  const int lo = rank * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  const U* dc = reinterpret_cast<const U*>(du) + c * g.hwu;
  const Chan p = chan(mean, rstd, scale, shift, c, relu);
  const bool keep = dx != nullptr;
  float a = 0.f, b = 0.f;
  for (Cursor<kU> cu(g, lo); cu.more(hi);) {
    int idx[kU], off[kU];
    cu.next(g, lo, hi, idx, off);
    U xv[kU], dv[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) {
        xv[j] = xc[off[j]];
        dv[j] = dc[off[j]];
      }
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) {
        if (keep) {
          xs[idx[j]] = xv[j];
          ds[idx[j]] = dv[j];
        }
        add_grads(xv[j], dv[j], p, a, b);
      }
  }
  const float2 t = total(a, b, sh, k, 0);
  if (rank == 0 && threadIdx.x == 0) {
    grads[c] = t.x;
    grads[C + c] = t.y;
  }
  if (keep) {
    const float db_n = t.x / g.n, dg_n = t.y / g.n;
    U* oc = reinterpret_cast<U*>(dx) + c * g.hwu;
    for (Cursor<1> cu(g, lo); cu.more(hi);) {
      int idx[1], off[1];
      cu.next(g, lo, hi, idx, off);
      oc[off[0]] = dx_unit(xs[idx[0]], ds[idx[0]], p, db_n, dg_n);
    }
  }
  if (k > 1) cg::this_cluster().sync();
}

// ---------------------------------------------------------------------------
// split plan: grid (S, C), one block per (chunk, channel)
// ---------------------------------------------------------------------------
// part[c * S + s] = (sum (x - cc), sum (x - cc)^2) over chunk s. The centre
// is center[c], or the mean of the first pass's partials `prev`, or 0 when
// both are null (the first pass of `exact`).
template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
fwd_partials(const T* __restrict__ x, const float* __restrict__ center,
             const float2* __restrict__ prev, float2* __restrict__ part,
             Geom g, int S) {
  using U = Unit<T, UB>;
  constexpr int kU = 4;
  __shared__ Scratch sh;
  const int s = blockIdx.x, c = blockIdx.y;
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  float cc = 0.f;
  if (prev != nullptr)
    cc = chunk_total(prev + c * S, S, sh).x / g.n;
  else if (center != nullptr)
    cc = center[c];
  float a = 0.f, b = 0.f;
  for (Cursor<kU> cu(g, lo); cu.more(hi);) {
    int idx[kU], off[kU];
    cu.next(g, lo, hi, idx, off);
    U v[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) v[j] = xc[off[j]];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) add_moments(v[j], cc, a, b);
  }
  const float2 t = total(a, b, sh, 1, 0);
  if (threadIdx.x == 0) part[c * S + s] = t;
}

template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
fwd_apply(const T* __restrict__ x, T* __restrict__ y,
          const float2* __restrict__ part, const float2* __restrict__ prev,
          const float* __restrict__ center, const float* __restrict__ gamma,
          const float* __restrict__ beta, float* __restrict__ stats, Geom g,
          int S, int C, float eps, int fix_gamma, int relu, int exact) {
  using U = Unit<T, UB>;
  __shared__ Scratch sh;
  const int s = blockIdx.x, c = blockIdx.y;
  const float2 t = chunk_total(part + c * S, S, sh);
  float mean, var;
  if (exact) {
    mean = chunk_total(prev + c * S, S, sh).x / g.n;
    var = t.y / g.n;
  } else {
    const float m1 = t.x / g.n, m2 = t.y / g.n;
    mean = center[c] + m1;
    var = fmaxf(m2 - m1 * m1, 0.f);
  }
  const Affine f = affine(mean, var, eps, gamma, beta, c, fix_gamma);
  if (s == 0 && threadIdx.x == 0) write_stats(stats, C, c, f);
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  U* yc = reinterpret_cast<U*>(y) + c * g.hwu;
  for (Cursor<1> cu(g, lo); cu.more(hi);) {
    int idx[1], off[1];
    cu.next(g, lo, hi, idx, off);
    yc[off[0]] = apply_unit(xc[off[0]], f, relu);
  }
}

template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
bwd_partials(const T* __restrict__ du, const T* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ scale,
             const float* __restrict__ shift, float2* __restrict__ part,
             Geom g, int S, int relu) {
  using U = Unit<T, UB>;
  constexpr int kU = 2;
  __shared__ Scratch sh;
  const int s = blockIdx.x, c = blockIdx.y;
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  const U* dc = reinterpret_cast<const U*>(du) + c * g.hwu;
  const Chan p = chan(mean, rstd, scale, shift, c, relu);
  float a = 0.f, b = 0.f;
  for (Cursor<kU> cu(g, lo); cu.more(hi);) {
    int idx[kU], off[kU];
    cu.next(g, lo, hi, idx, off);
    U xv[kU], dv[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) {
        xv[j] = xc[off[j]];
        dv[j] = dc[off[j]];
      }
#pragma unroll
    for (int j = 0; j < kU; ++j)
      if (idx[j] >= 0) add_grads(xv[j], dv[j], p, a, b);
  }
  const float2 t = total(a, b, sh, 1, 0);
  if (threadIdx.x == 0) part[c * S + s] = t;
}

// grads[:, c] = (dbeta, dgamma) from chunk 0; dx over chunk s when dx is
// not null (without dx the grid is (1, C)).
template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
bwd_apply(const T* __restrict__ du, const T* __restrict__ x,
          T* __restrict__ dx, const float* __restrict__ mean,
          const float* __restrict__ rstd, const float* __restrict__ scale,
          const float* __restrict__ shift, const float2* __restrict__ part,
          float* __restrict__ grads, Geom g, int S, int C, int relu) {
  using U = Unit<T, UB>;
  __shared__ Scratch sh;
  const int s = blockIdx.x, c = blockIdx.y;
  const float2 t = chunk_total(part + c * S, S, sh);
  if (s == 0 && threadIdx.x == 0) {
    grads[c] = t.x;
    grads[C + c] = t.y;
  }
  if (dx == nullptr) return;
  const Chan p = chan(mean, rstd, scale, shift, c, relu);
  const float db_n = t.x / g.n, dg_n = t.y / g.n;
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  const U* dc = reinterpret_cast<const U*>(du) + c * g.hwu;
  U* oc = reinterpret_cast<U*>(dx) + c * g.hwu;
  for (Cursor<1> cu(g, lo); cu.more(hi);) {
    int idx[1], off[1];
    cu.next(g, lo, hi, idx, off);
    oc[off[0]] = dx_unit(xc[off[0]], dc[off[0]], p, db_n, dg_n);
  }
}


// ---------------------------------------------------------------------------
// cross-rank split: one rank's per-channel partial sums, and the
// elementwise passes from the sums all-reduced over the ranks (the caller
// reduces one (C, 2) float tensor between a partials call and its apply).
// The passes over x use the split plan's grid (S, C); the partials of a
// channel's S chunks are added in chunk order by chunk_sums, grid (C).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSplitThreads)
chunk_sums(const float2* __restrict__ part, float2* __restrict__ out,
           int S) {
  __shared__ Scratch sh;
  const int c = blockIdx.x;
  const float2 t = chunk_total(part + c * S, S, sh);
  if (threadIdx.x == 0) out[c] = t;
}

// y over chunk s of channel c from the global sums: one-pass moments about
// center (mean = center + m1, var = max(m2 - m1^2, 0)), or, under exact,
// the mean given as center and var = sum (x - mean)^2 / n.
template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
fwd_apply_sums(const T* __restrict__ x, T* __restrict__ y,
               const float2* __restrict__ sums,
               const float* __restrict__ center,
               const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ stats,
               Geom g, int C, float n, float eps, int fix_gamma, int relu,
               int exact) {
  using U = Unit<T, UB>;
  const int s = blockIdx.x, c = blockIdx.y;
  const float2 t = sums[c];
  float mean, var;
  if (exact) {
    mean = center[c];
    var = t.y / n;
  } else {
    const float m1 = t.x / n, m2 = t.y / n;
    mean = center[c] + m1;
    var = fmaxf(m2 - m1 * m1, 0.f);
  }
  const Affine f = affine(mean, var, eps, gamma, beta, c, fix_gamma);
  if (s == 0 && threadIdx.x == 0) write_stats(stats, C, c, f);
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  U* yc = reinterpret_cast<U*>(y) + c * g.hwu;
  for (Cursor<1> cu(g, lo); cu.more(hi);) {
    int idx[1], off[1];
    cu.next(g, lo, hi, idx, off);
    yc[off[0]] = apply_unit(xc[off[0]], f, relu);
  }
}

// dx over chunk s of channel c from the global (dbeta, dgamma) sums.
template <typename T, int UB>
__global__ void __launch_bounds__(kSplitThreads)
bwd_dx_sums(const T* __restrict__ du, const T* __restrict__ x,
            T* __restrict__ dx, const float* __restrict__ mean,
            const float* __restrict__ rstd, const float* __restrict__ scale,
            const float* __restrict__ shift,
            const float2* __restrict__ sums, Geom g, float n, int relu) {
  using U = Unit<T, UB>;
  const int s = blockIdx.x, c = blockIdx.y;
  const Chan p = chan(mean, rstd, scale, shift, c, relu);
  const float2 t = sums[c];
  const float db_n = t.x / n, dg_n = t.y / n;
  const int lo = s * g.share, hi = min(lo + g.share, g.units);
  const U* xc = reinterpret_cast<const U*>(x) + c * g.hwu;
  const U* dc = reinterpret_cast<const U*>(du) + c * g.hwu;
  U* oc = reinterpret_cast<U*>(dx) + c * g.hwu;
  for (Cursor<1> cu(g, lo); cu.more(hi);) {
    int idx[1], off[1];
    cu.next(g, lo, hi, idx, off);
    oc[off[0]] = dx_unit(xc[off[0]], dc[off[0]], p, db_n, dg_n);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Raise `kernel`'s dynamic shared memory limit to kMaxDynSmem before its
// first launch on this device; `done` is the caller's per-kernel record.
cudaError_t allow_smem(const void* kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxDynSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), dim3 grid, int threads, int smem,
                   int cluster, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (cluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// What the Python plan gives one call.
struct Call {
  int plan, k, threads, smem, share, S, N, C, HW;
};

template <typename T, int UB>
Geom geom(const Call& a) {
  constexpr int kVec = UB / static_cast<int>(sizeof(T));
  Geom g;
  g.hwu = a.HW / kVec;
  g.chwu = a.C * g.hwu;
  g.units = a.N * g.hwu;
  g.share = a.share;
  g.q = a.threads / g.hwu;
  g.s = a.threads - g.q * g.hwu;
  g.n = static_cast<float>(a.N) * static_cast<float>(a.HW);
  return g;
}

bool valid(const Call& a, int unit_bytes, int elem_bytes) {
  const int vec = unit_bytes / elem_bytes;
  const int most = a.plan == kSplit ? kSplitThreads : kSlabThreads;
  return a.N > 0 && a.C > 0 && a.HW > 0 && a.HW % vec == 0 &&
         a.threads >= 32 && a.threads <= most && a.threads % 32 == 0 &&
         a.share > 0 && a.S > 0 && a.smem >= 0 && a.smem <= kMaxDynSmem &&
         (a.plan == kSplit || a.k == 1 || a.k == 2 || a.k == 4 || a.k == 8);
}

template <typename T, int UB>
cudaError_t fwd(const Call& a, const void* x, void* y, const float* gamma,
                const float* beta, const float* center, float* stats,
                float* scratch, float eps, int fix_gamma, int relu,
                int exact, cudaStream_t st) {
  const Geom g = geom<T, UB>(a);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (a.plan != kSplit) {
    static bool done[kMaxDevices] = {};
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(fwd_slab<T, UB>), done);
    if (e != cudaSuccess) return e;
    return launch(fwd_slab<T, UB>, dim3(a.C * a.k), a.threads, a.smem, a.k,
                  st, xt, yt, gamma, beta, center, stats, g, a.C, a.k, eps,
                  fix_gamma, relu, exact);
  }
  float2* part = reinterpret_cast<float2*>(scratch);
  float2* prev = exact ? part + a.C * a.S : nullptr;
  const dim3 grid(a.S, a.C);
  cudaError_t e;
  if (exact) {
    e = launch(fwd_partials<T, UB>, grid, a.threads, 0, 1, st, xt,
               static_cast<const float*>(nullptr),
               static_cast<const float2*>(nullptr), prev, g, a.S);
    if (e != cudaSuccess) return e;
  }
  e = launch(fwd_partials<T, UB>, grid, a.threads, 0, 1, st, xt,
             exact ? nullptr : center, static_cast<const float2*>(prev),
             part, g, a.S);
  if (e != cudaSuccess) return e;
  return launch(fwd_apply<T, UB>, grid, a.threads, 0, 1, st, xt, yt,
                static_cast<const float2*>(part),
                static_cast<const float2*>(prev), center, gamma, beta, stats,
                g, a.S, a.C, eps, fix_gamma, relu, exact);
}

template <typename T, int UB>
cudaError_t bwd(const Call& a, const void* du, const void* x, void* dx,
                const float* mean, const float* rstd, const float* scale,
                const float* shift, float* grads, float* scratch, int relu,
                cudaStream_t st) {
  const Geom g = geom<T, UB>(a);
  const T* dut = static_cast<const T*>(du);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  if (a.plan != kSplit) {
    static bool done[kMaxDevices] = {};
    const cudaError_t e =
        allow_smem(reinterpret_cast<const void*>(bwd_slab<T, UB>), done);
    if (e != cudaSuccess) return e;
    return launch(bwd_slab<T, UB>, dim3(a.C * a.k), a.threads, a.smem, a.k,
                  st, dut, xt, dxt, mean, rstd, scale, shift, grads, g, a.C,
                  a.k, relu);
  }
  float2* part = reinterpret_cast<float2*>(scratch);
  cudaError_t e = launch(bwd_partials<T, UB>, dim3(a.S, a.C), a.threads, 0,
                         1, st, dut, xt, mean, rstd, scale, shift, part, g,
                         a.S, relu);
  if (e != cudaSuccess) return e;
  return launch(bwd_apply<T, UB>, dim3(dx != nullptr ? a.S : 1, a.C),
                a.threads, 0, 1, st, dut, xt, dxt, mean, rstd, scale, shift,
                static_cast<const float2*>(part), grads, g, a.S, a.C, relu);
}

// The 11 ints of a call's plan, as kernels/batchnorm.py packs them.
enum PlanField { kDtype, kUnitBytes, kKind, kK, kThreads, kSmem, kShare,
                 kChunks, kN, kC, kHW };

bool decode(const int* p, Call& a, int& dtype, int& unit_bytes) {
  if (p == nullptr) return false;
  a = Call{p[kKind], p[kK], p[kThreads], p[kSmem], p[kShare], p[kChunks],
           p[kN], p[kC], p[kHW]};
  dtype = p[kDtype];
  unit_bytes = p[kUnitBytes];
  return (dtype == 0 || dtype == 1) &&
         valid(a, unit_bytes, dtype == 0 ? 4 : 2);
}


// The element type and unit width of a decoded plan, as a type for the
// generic lambdas of the split entry points.
template <typename T, int UB>
struct Tag {
  using type = T;
  static constexpr int ub = UB;
};

template <typename F>
cudaError_t dispatch(int dtype, int unit_bytes, F&& f) {
  switch (dtype * 100 + unit_bytes) {
    case 16: return f(Tag<float, 16>{});
    case 4: return f(Tag<float, 4>{});
    case 116: return f(Tag<__nv_bfloat16, 16>{});
    case 104: return f(Tag<__nv_bfloat16, 4>{});
    case 102: return f(Tag<__nv_bfloat16, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

// A split plan decoded, or false.
bool decode_split(const int* plan, Call& a, int& dtype, int& unit_bytes) {
  return decode(plan, a, dtype, unit_bytes) && a.plan == kSplit;
}
}  // namespace

// The forward of one BatchNorm(+ReLU): y, and stats = (mean, var, rstd,
// scale, shift) as 5 rows of C floats. `plan` holds the PlanField ints:
// dtype 0 is float32, 1 bfloat16; unit_bytes 16, 4 (or 2 for bfloat16)
// divides HW's bytes and every pointer's alignment; kind 0 block, 1
// cluster of k, 2 split into `chunks` chunks of `share` units, with
// 16-byte aligned scratch for 2·C·chunks float2 (under exact; else
// C·chunks). Returns the first failing launch's cudaError_t, 0 on success;
// a plan the kernels do not take returns cudaErrorInvalidValue without a
// launch.
extern "C" int mx_bn_fwd(const void* x, void* y, const float* gamma,
                         const float* beta, const float* center,
                         float* stats, float* scratch, const int* plan,
                         float eps, int fix_gamma, int relu, int exact,
                         int device, void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode(plan, a, dtype, unit_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MX_FWD(T, UB)                                                       \
  fwd<T, UB>(a, x, y, gamma, beta, center, stats, scratch, eps, fix_gamma, \
             relu, exact, st)
  switch (dtype * 100 + unit_bytes) {
    case 16: return static_cast<int>(MX_FWD(float, 16));
    case 4: return static_cast<int>(MX_FWD(float, 4));
    case 116: return static_cast<int>(MX_FWD(__nv_bfloat16, 16));
    case 104: return static_cast<int>(MX_FWD(__nv_bfloat16, 4));
    case 102: return static_cast<int>(MX_FWD(__nv_bfloat16, 2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MX_FWD
}

// The backward of one BatchNorm(+ReLU) from the forward's statistics:
// grads = (dbeta, dgamma) as 2 rows of C floats, and dx unless dx is null.
// Plan and return as mx_bn_fwd; the split plan's scratch holds
// C·chunks float2.
extern "C" int mx_bn_bwd(const void* du, const void* x, void* dx,
                         const float* mean, const float* rstd,
                         const float* scale, const float* shift,
                         float* grads, float* scratch, const int* plan,
                         int relu, int device, void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode(plan, a, dtype, unit_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MX_BWD(T, UB) \
  bwd<T, UB>(a, du, x, dx, mean, rstd, scale, shift, grads, scratch, relu, st)
  switch (dtype * 100 + unit_bytes) {
    case 16: return static_cast<int>(MX_BWD(float, 16));
    case 4: return static_cast<int>(MX_BWD(float, 4));
    case 116: return static_cast<int>(MX_BWD(__nv_bfloat16, 16));
    case 104: return static_cast<int>(MX_BWD(__nv_bfloat16, 4));
    case 102: return static_cast<int>(MX_BWD(__nv_bfloat16, 2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MX_BWD
}

// ---------------------------------------------------------------------------
// cross-rank split entry points (a split plan each; see the kernels above).
// Each returns the first failing launch's cudaError_t, 0 on success, and
// cudaErrorInvalidValue without a launch for a plan that is not a split.
// ---------------------------------------------------------------------------

// sums[c] = (sum (x - cc), sum (x - cc)^2) over this rank's rows, cc =
// center[c], or 0 when center is null. scratch: 16-byte aligned room for
// C * chunks float2.
extern "C" int mx_bn_fwd_partials(const void* x, const float* center,
                                  float* sums, float* scratch,
                                  const int* plan, int device,
                                  void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode_split(plan, a, dtype, unit_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(scratch);
  return static_cast<int>(dispatch(dtype, unit_bytes, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int UB = decltype(tag)::ub;
    const Geom g = geom<T, UB>(a);
    cudaError_t e = launch(fwd_partials<T, UB>, dim3(a.S, a.C), a.threads,
                           0, 1, st, static_cast<const T*>(x), center,
                           static_cast<const float2*>(nullptr), part, g,
                           a.S);
    if (e != cudaSuccess) return e;
    return launch(chunk_sums, dim3(a.C), kSplitThreads, 0, 1, st,
                  static_cast<const float2*>(part),
                  reinterpret_cast<float2*>(sums), a.S);
  }));
}

// y and stats = (mean, var, rstd, scale, shift) as 5 rows of C floats from
// the all-reduced sums over n elements a channel (see fwd_apply_sums).
extern "C" int mx_bn_fwd_apply(const void* x, void* y, const float* sums,
                               const float* center, const float* gamma,
                               const float* beta, float* stats,
                               const int* plan, float n, float eps,
                               int fix_gamma, int relu, int exact,
                               int device, void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode_split(plan, a, dtype, unit_bytes) || !(n > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, unit_bytes, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int UB = decltype(tag)::ub;
    const Geom g = geom<T, UB>(a);
    return launch(fwd_apply_sums<T, UB>, dim3(a.S, a.C), a.threads, 0, 1,
                  st, static_cast<const T*>(x), static_cast<T*>(y),
                  reinterpret_cast<const float2*>(sums), center, gamma,
                  beta, stats, g, a.C, n, eps, fix_gamma, relu, exact);
  }));
}

// sums[c] = (sum dv, sum dv * x^) over this rank's rows, dv = du masked by
// the ReLU. scratch as mx_bn_fwd_partials.
extern "C" int mx_bn_bwd_partials(const void* du, const void* x,
                                  const float* mean, const float* rstd,
                                  const float* scale, const float* shift,
                                  float* sums, float* scratch,
                                  const int* plan, int relu, int device,
                                  void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode_split(plan, a, dtype, unit_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(scratch);
  return static_cast<int>(dispatch(dtype, unit_bytes, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int UB = decltype(tag)::ub;
    const Geom g = geom<T, UB>(a);
    cudaError_t e = launch(bwd_partials<T, UB>, dim3(a.S, a.C), a.threads,
                           0, 1, st, static_cast<const T*>(du),
                           static_cast<const T*>(x), mean, rstd, scale,
                           shift, part, g, a.S, relu);
    if (e != cudaSuccess) return e;
    return launch(chunk_sums, dim3(a.C), kSplitThreads, 0, 1, st,
                  static_cast<const float2*>(part),
                  reinterpret_cast<float2*>(sums), a.S);
  }));
}

// dx from the all-reduced (dbeta, dgamma) sums over n elements a channel.
extern "C" int mx_bn_bwd_dx(const void* du, const void* x, void* dx,
                            const float* mean, const float* rstd,
                            const float* scale, const float* shift,
                            const float* sums, const int* plan, float n,
                            int relu, int device, void* stream) {
  Call a;
  int dtype, unit_bytes;
  if (!decode_split(plan, a, dtype, unit_bytes) || !(n > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  mxcuda::DeviceGuard on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, unit_bytes, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int UB = decltype(tag)::ub;
    const Geom g = geom<T, UB>(a);
    return launch(bwd_dx_sums<T, UB>, dim3(a.S, a.C), a.threads, 0, 1, st,
                  static_cast<const T*>(du), static_cast<const T*>(x),
                  static_cast<T*>(dx), mean, rstd, scale, shift,
                  reinterpret_cast<const float2*>(sums), g, n, relu);
  }));
}
