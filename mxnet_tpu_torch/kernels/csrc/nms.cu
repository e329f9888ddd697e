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
// * mx_nms_mask: boxes already sorted by score, (B, N, 4) corner format,
//   into N * ceil(N/64) 64-bit words an image: bit j of word w of row i
//   says iou(i, 64w + j) > thresh for 64w + j > i, and every other bit
//   (the lower triangle, the padding past N) is 0.
//   Bound: operations. The card's float32 bound counts 14 operations a
//   pair above the diagonal at 67 TFLOP/s, a rate that counts an fma as
//   two; this kernel may contract nothing (below), so half of that bound
//   is out of its reach by construction. What the design does:
//   (a) Only the tiles on or above the diagonal get a block (a triangular
//       grid, B * T(T+1)/2 blocks); each also writes the zero words of its
//       mirror tile below the diagonal, which gets no block of IoU work.
//   (b) Each box's area, rounded as _iou_matrix rounds it, is computed
//       once: the row boxes' into registers, the column boxes' into shared
//       memory beside them.
//   (c) No IEEE division where it cannot change the answer. For a finite
//       normal thresh t > 0 a pair is decided by the sign of
//       sc = inter - (alpha_a + alpha_b), alpha = area * t/(1 + t) for
//       each box (inter - union*t over 1 + t, up to roundings), whenever
//       |sc| > band, band = beta_a + beta_b, beta = area*tb + 2^-101,
//       tb = t/(1 + t) * 2^-19 + 2^-22 (rounded up): then inter/union
//       lies more than t*2^-20 from t, beyond the half ulp where
//       fl(inter/union) could round onto either side of t. The rest of a
//       word's pairs (the thin band around t, a union of 0, an overflow,
//       a box of area 2^127 or more, whose beta is inf, so that no
//       area_a + area_b overflows in a settled pair) are decided again,
//       the whole word, exactly: inter == 0 at once (an IoU of 0, above a
//       thresh <= 0), else __fdiv_rn(inter, union) > t. A thresh <= 0 (or
//       not a finite normal float) takes that exact decision on every
//       pair. The proof of the margin is in kernels/nms.py
//       (pair_decision), which mirrors it.
//   (d) A block of 64 threads takes a 128 x 128 tile, 2 rows a thread,
//       where the batch gives every SM kWideBlocksPerSM such blocks, else
//       a 64 x 64 tile, 1 row a thread. The wide tile serves each shared
//       column box to 2 rows and spreads one block's set-up over 16,384
//       pairs, not 4,096: it wins from 4 images of SSD300's 8,732 boxes
//       up. At one image (2,415 wide blocks for 132 SMs at 8,732 boxes,
//       1,128 at Proposal's 6,000) the narrow tile wins, at two they tie
//       (tools/nms_probe.py times each alone; PERF.md, Findings).
//   The unrolled loop issues 14 instructions a pair (5 min/max, 5 float
//   adds, 1 product, 2 compares, 1 predicated bit set) and ~1 of loads and
//   loop, in place of ~35 with the division: chip_smoke.py counts them in
//   the SASS. Half of the 14 run on the half-rate ALU pipe (the min/max,
//   the compares).
// * mx_nms_scan: one block an image walks the sorted order a 64-box tile at
//   a time: keep[i] = 1 iff box i was not removed, the greedy rule of the
//   JAX loop (box i suppresses j > i iff i is kept and iou > thresh).
//   Bound: latency, a chain of dependent tiles an image. What the design
//   does:
//   (a) Nothing on the chain waits for device memory. One settler warp
//       owns the chain and touches shared memory alone: each tile's band
//       (its 64 rows' words w .. w + kNear) is staged kRing tiles ahead
//       into a ring of kRing buffers with cp.async, by the other 31 warps
//       (the far warps), into the slots of tiles already settled. The
//       settler ORs a tile's kept rows' next kNear words itself, from the
//       band; the far warps OR the kept rows' later words straight from
//       device memory, off the chain, in batches of every tile settled
//       since their last batch, with native 32-bit shared atomics; the
//       settler waits for a batch only kNear tiles later. Only the far
//       warps off the settler's SM sub-partition (warp % 4 != 0) work, so
//       the settler's issue slot is its own. The keep flags go out once, at
//       the end, from each tile's kept bits in shared memory.
//   (b) A tile settles over its free rows in order (the rows no earlier
//       tile removed), not over all 64: their diagonal words are loaded
//       ahead, 8 at a time, so a row costs one test and one AND on the
//       chain. Jumping from one kept bit to the next (__ffsll of the bits
//       still free; -DMX_NMS_SCAN_FFS) puts a dependent shared load on the
//       chain at each kept row, and at SSD300's and Proposal's shapes
//       nearly every free row is kept, so it visits no fewer rows: it ran
//       slower at both (tools/nms_probe.py; PERF.md, Findings).
//   (c) One SM an image. The settler's chain (its walk and the rest of
//       each tile) fills ~90% of the block's cycles and its waits for the
//       far warps ~5% (-DMX_NMS_SCAN_TRACE), so the kernel runs at the
//       chain's speed; but the chain costs over a hundred cycles a kept
//       row, far above its one test and one AND, so it is not yet at its
//       floor. A cluster of SMs an image, or a shorter walk, is open work
//       (ROADMAP.md, queue B).
//   Reach: N <= 393,216 a call (kMaxScanWords words a tile set: removed
//   near, removed far and kept, in shared memory).
//
// Probe builds (tools/nms_probe.py; the shipped build defines none):
// MX_NMS_MASK_ROWS=1|2 takes that tile width at every shape,
// MX_NMS_SCAN_FFS the __ffsll walk, MX_NMS_SCAN_TRACE the settler's
// clock64 trace (mx_nms_scan_trace).
//
// Rounding: every line that rounds is one _rn intrinsic, in _iou_matrix's
// order, so nvcc contracts no product and sum into an fma, and the only
// division is IEEE: a pair at the threshold decides as it does in the JAX
// package. Deterministic: the mask's words are each written by one thread;
// the scan's ORs commute.
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>

#include "device.cuh"

namespace {

constexpr int kBits = 64;
constexpr int kMaskThreads = kBits;    // a thread a row (or R) of a tile
constexpr int kWideRows = 2;            // rows a thread in a wide tile
constexpr int kWideBlocksPerSM = 24;    // blocks an SM before tiles widen
constexpr int kBandShift = 19;          // tb = t/(1 + t) * 2^-19 + 2^-22
constexpr float kHalfFloor = 0x1p-101f;
constexpr float kAreaCap = 0x1p127f;   // areas below it sum to no inf
constexpr int kScanThreads = 1024;      // the settler warp and 31 far warps
constexpr int kFarThreads = kScanThreads - 32;
// far warps that work: those off the settler's SM sub-partition (warp % 4)
constexpr int kWorkers =
    (kScanThreads / 32 - 1 - (kScanThreads / 32 - 1) / 4) * 32;
constexpr int kNear = 6;                // words the settler ORs itself
constexpr int kBand = kNear + 1;        // staged words a row: its own, kNear
constexpr int kRing = 8;                // staged tiles
constexpr int kFarBatch = 8;            // rows a far thread ORs at once
constexpr int kMaxScanWords = 48 * 1024 / 8;
constexpr int kScanWordSets = 3;        // near, far and kept: a word a tile
constexpr int kMaxDevices = 64;

#ifdef MX_NMS_SCAN_TRACE
// tools/nms_probe.py's build: the settler's clock64 cycles in each of the
// first kTraceBlocks images of the last scan, read by mx_nms_scan_trace
constexpr int kTraceBlocks = 64;
enum TraceField {
  kTrBlock,     // the block, from its start to its last keep flag
  kTrSettler,   // the settler's loop over the tiles
  kTrWait,      // ... waiting for the far warps' ORs
  kTrWalk,      // ... settling the tiles' rows
  kTrRest,      // ... the kept rows' list, the near ORs, the release
  kTrVisits,    // rows the walk visited
  kTrKept,      // rows kept
  kTrFields
};
__device__ long long g_scan_trace[kTraceBlocks][kTrFields];
#endif

struct Box {
  float x1, y1, x2, y2;
};

__device__ __forceinline__ Box load_box(const float* p) {
  return Box{p[0], p[1], p[2], p[3]};
}

// _iou_matrix's area line: max((x2 - x1) * (y2 - y1), 0), one rounding each.
__device__ __forceinline__ float area_of(const Box& b) {
  return fmaxf(__fmul_rn(__fsub_rn(b.x2, b.x1), __fsub_rn(b.y2, b.y1)), 0.0f);
}

// A box's share of a pair's band: area * tb + 2^-101, or inf for an area
// of 2^127 or more, so that every pair whose area_a + area_b may overflow
// (and with it the union) takes the exact decision.
__device__ __forceinline__ float beta_of(float area, float tb) {
  return area >= kAreaCap ? INFINITY
                          : __fadd_rn(__fmul_rn(area, tb), kHalfFloor);
}

// A box's share of the fast test's subtrahend: area * tp, tp = t / (1 + t).
__device__ __forceinline__ float alpha_of(float area, float tp) {
  return __fmul_rn(area, tp);
}

// fl(inter / union) > t with _iou_matrix's lines, one rounding each, in its
// order; an IoU of 0 (inter == 0) decides at once.
__device__ __forceinline__ bool exact_bit(const Box& a, float area_a,
                                          const Box& b, float area_b,
                                          float t) {
  const float iw =
      fmaxf(__fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1)), 0.0f);
  const float ih =
      fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (inter == 0.0f) return 0.0f > t;
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > t;
}

// The fast decision for a finite normal t > 0: the sign of
// sc = inter - (alpha_a + alpha_b), that is of inter - union * t divided by
// 1 + t, returned; `unsure` flags where it may not be that of
// fl(inter / union) - t. The width goes unclamped into inter: a negative
// one makes inter <= 0 (no overlap, sc <= 0) as the clamp would.
__device__ __forceinline__ float fast_score(const Box& a, float alpha_a,
                                            float beta_a, const Box& b,
                                            float alpha_b, float beta_b,
                                            bool& unsure) {
  const float dw = __fsub_rn(fminf(a.x2, b.x2), fmaxf(a.x1, b.x1));
  const float ih =
      fmaxf(__fsub_rn(fminf(a.y2, b.y2), fmaxf(a.y1, b.y1)), 0.0f);
  const float inter = __fmul_rn(dw, ih);
  const float sc = __fsub_rn(inter, __fadd_rn(alpha_a, alpha_b));
  const float band = __fadd_rn(beta_a, beta_b);
  unsure |= !(fabsf(sc) > band);
  return sc;
}

// acc |= bit where sc > 0, as one predicated OR (nvcc's own code for the
// condition is a select and an OR, two instructions a pair).
__device__ __forceinline__ void or_if_above(unsigned& acc, float sc,
                                            unsigned bit) {
  asm("{\n\t.reg .pred p;\n\tsetp.gt.f32 p, %1, 0f00000000;\n\t"
      "@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(acc)
      : "f"(sc), "r"(bit));
}

// Tile pair k of the upper triangle of a T x T grid of tiles.
__device__ __forceinline__ void tile_of(int k, int T, int& rt, int& ct) {
  const long long kp = static_cast<long long>(T) * (T + 1) / 2 - 1 - k;
  long long q = static_cast<long long>((sqrt(8.0 * kp + 1.0) - 1.0) * 0.5);
  while (q * (q + 1) / 2 > kp) --q;
  while ((q + 1) * (q + 2) / 2 <= kp) ++q;
  rt = T - 1 - static_cast<int>(q);
  ct = T - 1 - static_cast<int>(kp - q * (q + 1) / 2);
}

// R rows a thread, a (64R x 64R) tile a block; kFast: t is a finite normal
// float above 0.
template <int R, bool kFast>
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float* __restrict__ boxes,
                    unsigned long long* __restrict__ mask, int n, int words,
                    int tiles, float t, float tp, float tb) {
  constexpr int kTile = kMaskThreads * R;   // R words of 64 columns
  constexpr int kChunk = R == 1 ? 32 : 16;  // columns unrolled at a time
  __shared__ float4 cbox[kTile];
  __shared__ float2 cfast[kTile];           // alpha, beta
  __shared__ float carea[kTile];
  int rt, ct;
  tile_of(blockIdx.x, tiles, rt, ct);
  const float* img = boxes + static_cast<size_t>(blockIdx.y) * n * 4;
  unsigned long long* out =
      mask + static_cast<size_t>(blockIdx.y) * n * words;
  const int r0 = rt * kTile, c0 = ct * kTile;
  for (int c = threadIdx.x; c < kTile; c += kMaskThreads) {
    const Box b = load_box(img + 4 * min(c0 + c, n - 1));
    const float ar = area_of(b);
    cbox[c] = make_float4(b.x1, b.y1, b.x2, b.y2);
    cfast[c] = make_float2(alpha_of(ar, tp), beta_of(ar, tb));
    carea[c] = ar;
  }
  Box a[R];
  float aa[R], al[R], ab[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    a[k] = load_box(img + 4 * min(r0 + threadIdx.x + k * kMaskThreads,
                                  n - 1));
    aa[k] = area_of(a[k]);
    al[k] = alpha_of(aa[k], tp);
    ab[k] = beta_of(aa[k], tb);
  }
  if (rt != ct) {   // the mirror tile, below the diagonal: zeros
    for (int i = threadIdx.x; i < kTile * R; i += kMaskThreads) {
      const int row = c0 + i / R, w = rt * R + i % R;
      if (row < n && w < words) out[static_cast<size_t>(row) * words + w] = 0;
    }
  }
  __syncthreads();
  for (int cw = 0; cw < R; ++cw) {
    const int w = ct * R + cw;
    if (w >= words) break;
    const float4* cb = cbox + cw * kBits;
    const float2* cd = cfast + cw * kBits;
    const float* ce = carea + cw * kBits;
    unsigned long long bits[R];
#pragma unroll
    for (int k = 0; k < R; ++k) bits[k] = 0;
    bool unsure = false;
#pragma unroll 1
    for (int j0 = 0; j0 < kBits; j0 += kChunk) {
      unsigned acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = 0;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float4 c = cb[j0 + u];
        const float2 d = cd[j0 + u];
        const Box b{c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < R; ++k) {
          if (kFast)
            or_if_above(acc[k],
                        fast_score(a[k], al[k], ab[k], b, d.x, d.y, unsure),
                        1u << u);
          else if (exact_bit(a[k], aa[k], b, ce[j0 + u], t))
            acc[k] |= 1u << u;
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k)
        bits[k] |= static_cast<unsigned long long>(acc[k]) << j0;
    }
    if (kFast && unsure) {   // the word again, every pair exactly
#pragma unroll
      for (int k = 0; k < R; ++k) bits[k] = 0;
      for (int j = 0; j < kBits; ++j) {
        const float4 c = cb[j];
        const Box b{c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (exact_bit(a[k], aa[k], b, ce[j], t)) bits[k] |= 1ull << j;
      }
    }
    const int left = n - w * kBits;
    const unsigned long long cols = left >= kBits ? ~0ull : (1ull << left) - 1;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int row = r0 + threadIdx.x + k * kMaskThreads;
      if (row >= n) continue;
      unsigned long long v = bits[k] & cols;
      const int rw = row / kBits, rb = row % kBits;
      if (w < rw) v = 0;                        // left of the diagonal
      else if (w == rw) v &= rb == kBits - 1 ? 0ull : ~0ull << (rb + 1);
      out[static_cast<size_t>(row) * words + w] = v;
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(smem_addr(p)),
               "r"(v)
               : "memory");
}

// The far warps' own barrier (the settler never waits at it).
__device__ __forceinline__ void far_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFarThreads) : "memory");
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(~0u, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(~0u, static_cast<unsigned>(v >> 32));
  return static_cast<unsigned long long>(hi) << 32 | lo;
}

// The bands of tiles lo..hi (a row's words w .. w + kNear of tile w) into
// their ring slots, by threads tid, tid + nthreads, ... of the caller.
__device__ __forceinline__ void stage_bands(
    unsigned long long (*band)[kBits][kBand],
    const unsigned long long* m, int n, int words, int lo, int hi, int tid,
    int nthreads) {
  constexpr int per = kBits * kBand;
  for (int i = tid; i < (hi - lo + 1) * per; i += nthreads) {
    const int s = lo + i / per, r = i % per / kBand, d = i % kBand;
    if (s * kBits + r < n && s + d < words)
      cp_async8(&band[s % kRing][r][d],
                m + static_cast<size_t>(s * kBits + r) * words + s + d);
  }
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const unsigned long long* __restrict__ mask,
                    bool* __restrict__ keep, int n, int words) {
  // removed bits, near (the settler's ORs) and far (the far warps'), and
  // each tile's kept bits
  extern __shared__ unsigned long long words_of[];
  unsigned long long* near_w = words_of;
  unsigned long long* far_w = words_of + words;
  unsigned long long* kept_w = words_of + 2 * words;
  __shared__ unsigned long long band[kRing][kBits][kBand];
  __shared__ unsigned char kept_rows[kRing][kBits];
  __shared__ int kept_count[kRing];
  __shared__ unsigned long long cand_word[kBits];   // the settler's tile
  __shared__ unsigned char cand_row[kBits];
  __shared__ int far_items[kRing + 1];
  __shared__ int settled, far_done, far_upto;
  const unsigned long long* m =
      mask + static_cast<size_t>(blockIdx.x) * n * words;
#ifdef MX_NMS_SCAN_TRACE
  const long long tr_start = clock64();
  long long tr[kTrFields] = {};
#endif
  for (int w = threadIdx.x; w < 2 * words; w += kScanThreads) words_of[w] = 0;
  if (threadIdx.x == 0) settled = far_done = -1;
  stage_bands(band, m, n, words, 0, min(kRing, words) - 1, threadIdx.x,
              kScanThreads);
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    // the settler: the chain of tiles, on shared memory alone
#ifdef MX_NMS_SCAN_TRACE
    const long long settler_start = clock64();
#endif
    for (int s = 0; s < words; ++s) {
#ifdef MX_NMS_SCAN_TRACE
      const long long c0 = clock64();
#endif
      if (s > kNear)
        while (ld_acquire(&far_done) < s - kNear - 1) {
        }
#ifdef MX_NMS_SCAN_TRACE
      const long long c1 = clock64();
#endif
      const unsigned long long(*bd)[kBand] = band[s % kRing];
      const int base = s * kBits, cnt = min(kBits, n - base);
      const unsigned long long valid =
          cnt == kBits ? ~0ull : (1ull << cnt) - 1;
      const unsigned long long cand = ~(near_w[s] | far_w[s]) & valid;
#ifdef MX_NMS_SCAN_FFS
      // the probe's other walk: from one kept bit to the next, a dependent
      // shared load of the row's diagonal word at each
      unsigned long long free = cand, kept = 0;
      int visits = 0;
      while (free) {
        const int r = __ffsll(static_cast<long long>(free)) - 1;
        kept |= 1ull << r;
        free &= ~(bd[r][0] | 1ull << r);
        ++visits;
      }
#else
      // the free rows in order, each with its diagonal word: their loads
      // run ahead of the chain, which is one test and one AND a row
      const int nc = __popcll(cand), visits = nc;
      for (int r = lane; r < kBits; r += 32)
        if ((cand >> r) & 1) {
          const int k = __popcll(cand & ((1ull << r) - 1));
          cand_row[k] = static_cast<unsigned char>(r);
          cand_word[k] = bd[r][0];
        }
      __syncwarp();
      unsigned long long free = cand, kept = 0;
      for (int k0 = 0; k0 < nc; k0 += 8) {
        unsigned long long bit[8], d[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          bit[q] = k0 + q < nc ? 1ull << cand_row[k0 + q] : 0ull;
          d[q] = cand_word[k0 + q];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (free & bit[q]) {
            kept |= bit[q];
            free &= ~d[q];
          }
      }
#endif
#ifdef MX_NMS_SCAN_TRACE
      asm volatile("" ::"l"(kept) : "memory");
      const long long c2 = clock64();
#else
      (void)visits;
#endif
      const int slot = s % kRing;
      for (int r = lane; r < kBits; r += 32)   // the kept rows, in order
        if ((kept >> r) & 1)
          kept_rows[slot][__popcll(kept & ((1ull << r) - 1))] =
              static_cast<unsigned char>(r);
      if (kept) {   // the kept rows' next kNear words, all at once
        const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
        unsigned long long v[kNear], mine = 0;
#pragma unroll
        for (int d = 0; d < kNear; ++d)
          v[d] = (k0 ? bd[lane][d + 1] : 0ull) |
                 (k1 ? bd[lane + 32][d + 1] : 0ull);
#pragma unroll
        for (int d = 0; d < kNear; ++d) {
          v[d] = warp_or(v[d]);
          if (lane == d + 1) mine = v[d];
        }
        if (lane >= 1 && lane <= kNear && s + lane < words)
          near_w[s + lane] |= mine;
      }
      if (lane == 0) {
        kept_w[s] = kept;
        kept_count[slot] = __popcll(kept);
      }
      __syncwarp();
      if (lane == 0) st_release(&settled, s);
#ifdef MX_NMS_SCAN_TRACE
      const long long c3 = clock64();
      tr[kTrWait] += c1 - c0;
      tr[kTrWalk] += c2 - c1;
      tr[kTrRest] += c3 - c2;
      tr[kTrVisits] += visits;
      tr[kTrKept] += __popcll(kept);
#endif
    }
#ifdef MX_NMS_SCAN_TRACE
    tr[kTrSettler] = clock64() - settler_start;
#endif
  } else {
    // the far warps: the kept rows' words past the settler's band, and the
    // bands of the tiles kRing ahead into the slots of the settled ones
    const int ft = threadIdx.x - 32, warp = threadIdx.x / 32;
    const bool worker = warp % 4 != 0;
    const int wt = (warp - 1 - warp / 4) * 32 + lane;
    const int last = words - kNear - 2;   // the last tile with such words
    // item g of a batch: tile u0 + i, word t, kept rows c .. c + kFarBatch
    auto item = [&](int u0, int g, int& t) {
      int i = 0;
      while (far_items[i + 1] <= g) ++i;
      const int u = u0 + i, local = g - far_items[i];
      const int nk = kept_count[u % kRing];
      const int t0 = u + kNear + 1, nt = words - t0;
      const int c = local / nt * kFarBatch;
      t = t0 + local % nt;
      const unsigned char* rows = kept_rows[u % kRing];
      const unsigned long long* tile =
          m + static_cast<size_t>(u) * kBits * words + t;
      unsigned long long acc = 0;
#pragma unroll
      for (int q = 0; q < kFarBatch; ++q)
        if (c + q < nk)
          acc |= __ldg(tile + static_cast<size_t>(rows[c + q]) * words);
      return acc;
    };
    auto or_far = [&](int t, unsigned long long v) {   // two native ORs
      unsigned* w = reinterpret_cast<unsigned*>(far_w + t);
      if (static_cast<unsigned>(v)) atomicOr(w, static_cast<unsigned>(v));
      if (v >> 32) atomicOr(w + 1, static_cast<unsigned>(v >> 32));
    };
    for (int u0 = 0; u0 <= last;) {
      if (ft == 0) {
        int s;
        while ((s = ld_acquire(&settled)) < u0) __nanosleep(20);
        const int u1 = min(s, last);
        far_upto = u1;
        int total = 0;
        for (int u = u0; u <= u1; ++u) {
          far_items[u - u0] = total;
          total += (words - u - kNear - 1) *
                   ((kept_count[u % kRing] + kFarBatch - 1) / kFarBatch);
        }
        far_items[u1 - u0 + 1] = total;
      }
      far_sync();
      const int u1 = far_upto, total = far_items[u1 - u0 + 1];
      if (worker) {
        stage_bands(band, m, n, words, u0 + kRing,
                    min(u1 + kRing, words - 1), wt, kWorkers);
        for (int g = wt; g < total; g += 2 * kWorkers) {   // two at once
          int ta, tb = 0;
          const unsigned long long a = item(u0, g, ta);
          const unsigned long long b =
              g + kWorkers < total ? item(u0, g + kWorkers, tb) : 0ull;
          or_far(ta, a);
          if (b) or_far(tb, b);
        }
        cp_async_wait_all();
      }
      __threadfence_block();
      far_sync();
      if (ft == 0) st_release(&far_done, u1);
      u0 = u1 + 1;
    }
  }
  __syncthreads();
  bool* k = keep + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kScanThreads)
    k[i] = (kept_w[i / kBits] >> (i % kBits)) & 1;
#ifdef MX_NMS_SCAN_TRACE
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {
    tr[kTrBlock] = clock64() - tr_start;
    for (int f = 0; f < kTrFields; ++f) g_scan_trace[blockIdx.x][f] = tr[f];
  }
#endif
}

// Raise the scan's dynamic shared memory limit once a device.
cudaError_t allow_scan_smem(int device) {
  static bool done[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kScanWordSets * kMaxScanWords *
          static_cast<int>(sizeof(unsigned long long)));
  if (e == cudaSuccess && device >= 0 && device < kMaxDevices)
    done[device] = true;
  return e;
}

template <int R, bool kFast>
void launch_mask(const float* boxes, unsigned long long* mask, int batch,
                 int n, int words, int tiles, long long pairs, float t,
                 float tp, float tb, cudaStream_t stream) {
  nms_mask_kernel<R, kFast><<<dim3(static_cast<unsigned>(pairs), batch),
                              kMaskThreads, 0, stream>>>(
      boxes, mask, n, words, tiles, t, tp, tb);
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
#ifdef MX_NMS_MASK_ROWS
  // tools/nms_probe.py's builds: one tile width (1 or 2 rows a thread) at
  // every shape
  const bool wide = MX_NMS_MASK_ROWS == kWideRows;
#else
  // wide tiles where the batch gives every SM kWideBlocksPerSM of them
  // (design (d) above)
  int sms = 0;
  const cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long wide_tiles = (n + kBits * kWideRows - 1) /
                               (kBits * kWideRows);
  const bool wide = batch * (wide_tiles * (wide_tiles + 1) / 2) >=
                    static_cast<long long>(kWideBlocksPerSM) * sms;
#endif
  const int tile = wide ? kBits * kWideRows : kBits;
  const long long tiles = (n + tile - 1) / tile;
  const long long pairs = tiles * (tiles + 1) / 2;
  if (pairs > INT_MAX) return cudaErrorInvalidValue;
  // the fast decision needs a finite normal thresh above 0; tp is
  // thresh / (1 + thresh) rounded, tb the band's share of an area,
  // tp * 2^-19 + 2^-22 rounded up
  const bool fast = thresh >= FLT_MIN && thresh <= FLT_MAX;
  float tp = 0.0f, tb = 0.0f;
  if (fast) {
    const double q = thresh / (1.0 + thresh);
    tp = static_cast<float>(q);
    const double want = std::ldexp(q, -kBandShift) + std::ldexp(1.0, -22);
    tb = static_cast<float>(want);
    if (static_cast<double>(tb) < want) tb = std::nextafter(tb, INFINITY);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = static_cast<int>(tiles);
  if (wide && fast)
    launch_mask<kWideRows, true>(boxes, mask, batch, n, words, T, pairs,
                                 thresh, tp, tb, s);
  else if (wide)
    launch_mask<kWideRows, false>(boxes, mask, batch, n, words, T, pairs,
                                  thresh, tp, tb, s);
  else if (fast)
    launch_mask<1, true>(boxes, mask, batch, n, words, T, pairs, thresh, tp,
                         tb, s);
  else
    launch_mask<1, false>(boxes, mask, batch, n, words, T, pairs, thresh,
                          tp, tb, s);
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
  const cudaError_t e = allow_scan_smem(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  nms_scan_kernel<<<batch, kScanThreads,
                    kScanWordSets * words * sizeof(unsigned long long),
                    static_cast<cudaStream_t>(stream)>>>(mask, keep, n,
                                                         words);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MX_NMS_SCAN_TRACE
// The settler trace of the last mx_nms_scan on the current device: its
// first `blocks` images (at most kTraceBlocks), kTrFields int64 each.
extern "C" int mx_nms_scan_trace(long long* out, int blocks) {
  if (blocks <= 0 || blocks > kTraceBlocks) return cudaErrorInvalidValue;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_scan_trace, sizeof(long long) * kTrFields * blocks));
}
#endif
