// Multilevel aligned RoIAlign, backward, for Hopper (sm_90a).
//
// The gradient of the direct kernel (roi_align.cu), which replaces the TPU
// kernels monorun_tpu/ops/roi_align_sorted.py:_sorted_kernel (every align
// of the training step) and roi_align_band.py:_band_kernel. The JAX
// package differentiates monorun_tpu/ops/roi_align.py:multilevel_roi_align
// with jax.grad; the plain PyTorch version these kernels are held to is
// autograd through monorun_tpu_torch/ops/roi_align.py:multilevel_roi_align.
//
// Function: given the output gradient g (n, out_h, out_w, C), in the
// features' dtype,
//   d level: for every RoI, bin and sample, g times each bilinear weight
//     times 1/(gh*gw), added into that sample's taps in the RoI's level;
//     written per level (B, H_l, W_l, C) in the levels' dtype;
//   d rois: the derivative through the sample coordinates. A sample at
//     c = start * (1 - a) + end * a, a = (bin + (k + 0.5) / g) / out, with
//     start, end the RoI's edges times the level's 1/stride minus 0.5,
//     moves its two taps' weights by -+1 per unit of the clamped coordinate;
//     the clamp min(max(c, 0), size - 1) passes 1 inside, 1/2 at a bound
//     (as jnp.clip and torch.maximum/minimum do at a tie) and 0 outside;
//     samples outside [-1, size] carry no gradient. The level choice and
//     the sample count are steps of the RoI, with no gradient. Written as
//     (x1, y1, x2, y2) per RoI and block of bins: (gridDim.y, n, 4).
//
// Bound: bytes. The output gradient read, the touched level cells read
// (for d rois), the dense level gradient written once in the levels'
// dtype. A scatter of every tap into the levels would move far more: a
// float32 scratch of the whole pyramid zero-filled, a read-modify-write
// per tap in L2, a cast pass; and float atomics sum in an order that
// changes from run to run. So the level gradient is gathered by its
// cells instead, and no kernel here has an atomic:
//
// 1. roi_align_backward_rois_kernel, one block per RoI (its bins dealt
//    over blockIdx.y when there are few RoIs), one warp per bin, a 16-byte
//    channel vector per lane: the forward's per-row and per-column lists
//    of distinct taps with merged weights (roi_align_geometry.cuh), built
//    once in shared memory. It writes them out with the RoI's key (image
//    x levels + level) and the rectangle of cells its taps reach, for the
//    tile kernel, and whether the RoI's output gradient is nonzero (a RoI
//    whose gradient is zero adds exact zeros: padded sample slots). And d
//    rois: the bilinear weight factorises, so a second pair of lists holds
//    every distinct tap of a row's (column's) samples with its merged
//    weight and its merged derivative with respect to the RoI's two edges
//    along that axis; each tap (row a, column c) of a bin is then loaded
//    once, and <g, F[a, c]> moves the y edges by a's derivatives times c's
//    weight and the x edges by a's weight times c's derivatives. Each lane
//    keeps its channels' share of the four sums; the block reduces them.
// 2. roi_align_backward_buckets_kernel, one block: a stable counting sort
//    of the RoIs with a nonzero gradient by key (ballots and per-warp
//    counts, no atomics): each (image, level)'s RoIs in RoI order, and the
//    buckets' offsets.
// 3. roi_align_backward_levels_kernel, one block per (image, level, tile
//    of kTileRows x kTileCols cells, slice of 32 x kLaneChannels channels),
//    covering every cell, ragged edges included. Warp w owns the tile's row
//    w, and each lane its kLaneChannels channels (one 16-byte vector in
//    bfloat16, two 512 bytes apart in float32) of kTileCols cells, summed
//    in float32 registers: one writer per cell. The block walks its bucket
//    in RoI order and keeps the RoIs whose rectangle meets the tile (a
//    block-wide ballot). It takes them kGroup at a time: their lists
//    become weight tables of the tile's rows and columns in shared memory,
//    and the output gradient of every bin that reaches the tile is staged
//    in shared memory by the whole block, 32 KB at a time, so that a group
//    costs a few waits on memory whatever its size (RoIs pile up on the
//    stride-4 levels). Each
//    warp then adds w_row * w_col * g over the staged bins whose row list
//    holds its row, in (RoI, bin row, bin column) order: the sums are the
//    same bit for bit on every run. The tile is written once, in the
//    levels' dtype; cells no tap reached get 0.
//
// What holds it back on the H100 (phase 9 and 10 of chip_smoke.py): the
// tile kernel's busy tiles are bound by instruction issue and the latency
// of their staging rounds, its idle tiles by the write of their cells; the
// per-RoI kernel's RoI gradient by the load of each tap per bin.
//
// Build: as roi_align.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -fmad=false ...), so the shared coordinate code rounds as the forward's;
// the sums use explicit __fmaf_rn.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using roi_align::kFull;
using roi_align::kMaxLevels;
using roi_align::kMaxRatio;
using roi_align::Pyramid;

constexpr int kMaxWarps = 16;        // the per-RoI kernel's warps per block
constexpr int kTileRows = 8;         // the tile kernel: one warp per tile row
constexpr int kTileCols = 4;         // cells of a warp's row segment
constexpr int kLaneChannels = 8;     // channels a lane sums in each of them
constexpr int kMaxOutW = 32;         // the tile kernel's mask of a RoI's bin columns
constexpr int kBucketThreads = 1024;
constexpr int kMaxKeys = 352;        // images x levels: the sort's counts fit 48 KB

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kWidth = 4;
  __device__ static void load(const char* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void unpack(const uint4 q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static void store(char* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  // element 2i is the low half of word i; a bfloat16 is the high half of
  // its float32
  __device__ static void load(const char* p, float* v) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  __device__ static void unpack(const uint4 q, float* v) {
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  // rounded to nearest even, as a float32 tensor's .to(torch.bfloat16)
  __device__ static void store(char* p, const float* v) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// A list entry: a distinct tap (row or column index) and its merged
// weight; a tap of -1 marks an unused slot of a written-out list.
struct Entry {
  int tap;
  float weight;
};

__device__ __forceinline__ Entry load_entry(const Entry* e) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(e));
  return Entry{v.x, __int_as_float(v.y)};
}

// An entry of a list for the RoI gradient: a distinct tap of the list's
// samples (zero weight included), its merged weight w, and its merged
// coordinate coefficients c1, c2: the derivative of the tap's weight with
// respect to the RoI's start and end edge, summed over the list's samples.
// A sample at c = start (1 - a) + end a with near tap t0 and far tap t1
// moves them by -+coef per unit of c, coef = d(far weight)/dc (0 when the
// sample is dead, outside [-1, size], clamped, or its two taps coincide).
struct GradEntry {
  int tap;
  float w, c1, c2;
};

// Every lane of the warp calls this together, lane i of each half with
// sample i of its half's list (list_taps' t and the sample's coefficient
// and a): the distinct taps of the list's live samples, merged in tap
// order (near, far of sample 0, ...) as list_taps merges them but keeping
// the taps of zero weight, written to `list`; returns their count.
__device__ __forceinline__ int grad_list(const roi_align::ListTaps& t, float coef, float a,
                                         float w0, float w1, float cscale, int g, int gmax,
                                         int lane, GradEntry* list) {
  const int half_base = lane & 16, i = lane & 15;
  const float n1 = -coef * (1.f - a) * cscale, n2 = -coef * a * cscale;
  float s0w = 0.f, s0a = 0.f, s0b = 0.f, s1w = 0.f, s1a = 0.f, s1b = 0.f;
  bool own0 = t.live, own1 = t.live && t.t1 != t.t0;
  for (int j = 0; j < gmax; ++j) {
    const int src = half_base + j;
    const int a0 = __shfl_sync(kFull, t.t0, src), a1 = __shfl_sync(kFull, t.t1, src);
    const float b0 = __shfl_sync(kFull, w0, src), b1 = __shfl_sync(kFull, w1, src);
    const float m1 = __shfl_sync(kFull, n1, src), m2 = __shfl_sync(kFull, n2, src);
    if (j < g) {
      // the near tap's coefficients are (m1, m2), the far tap's (-m1, -m2)
      s0w += (a0 == t.t0 ? b0 : 0.f) + (a1 == t.t0 ? b1 : 0.f);
      s0a += (a0 == t.t0 ? m1 : 0.f) - (a1 == t.t0 ? m1 : 0.f);
      s0b += (a0 == t.t0 ? m2 : 0.f) - (a1 == t.t0 ? m2 : 0.f);
      s1w += (a0 == t.t1 ? b0 : 0.f) + (a1 == t.t1 ? b1 : 0.f);
      s1a += (a0 == t.t1 ? m1 : 0.f) - (a1 == t.t1 ? m1 : 0.f);
      s1b += (a0 == t.t1 ? m2 : 0.f) - (a1 == t.t1 ? m2 : 0.f);
      if (j < i) {
        own0 = own0 && a0 != t.t0 && a1 != t.t0;
        own1 = own1 && a0 != t.t1 && a1 != t.t1;
      }
    }
  }
  const unsigned m0 = (__ballot_sync(kFull, own0) >> half_base) & 0xffffu;
  const unsigned mf = (__ballot_sync(kFull, own1) >> half_base) & 0xffffu;
  const unsigned below = (1u << i) - 1u;
  if (own0) list[__popc(m0 & below)] = GradEntry{t.t0, s0w, s0a, s0b};
  if (own1) list[__popc(m0) + __popc(mf & below)] = GradEntry{t.t1, s1w, s1a, s1b};
  return __popc(m0) + __popc(mf);
}

// ---- 1. per RoI: tap lists, key, rectangle; d rois -------------------------

struct RoIParams {
  const float* rois;
  const void* grad_out;        // (n, out_h, out_w, C) in the features' dtype
  float* grad_rois;            // (gridDim.y, n, 4) partial sums, or null
  int* live;                   // (gridDim.y, n): a nonzero output gradient in the
                               // block's bins, or null
  Entry* lists;                // (n, out_h + out_w, 2 max_ratio), or null
  int4* rects;                 // (n,) rows [x, y), columns [z, w), or null
  int* keys;                   // (n,) image * levels + level, or null
  int n, batch, channels, out_h, out_w, max_ratio;
  float finest_scale, span_limit;
};

// one block of kMaxWarps per SM at least: without the bound ptxas keeps
// the float32 build at 64 registers and spills
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
roi_align_backward_rois_kernel(const Pyramid pyr, const RoIParams p) {
  constexpr int V = Vec<T>::kWidth;
  extern __shared__ int4 smem[];
  const long long r = blockIdx.x;
  const roi_align::RoIGeometry geo = roi_align::roi_geometry(
      p.rois + 5 * r, pyr, p.batch, p.out_h, p.out_w, p.max_ratio, p.finest_scale,
      p.span_limit);
  const int lvl = geo.lvl;

  const int L = 2 * p.max_ratio;                  // entries per list
  const int n_lists = p.out_h + p.out_w;
  GradEntry* grad_lists = reinterpret_cast<GradEntry*>(smem);
  Entry* lists = reinterpret_cast<Entry*>(grad_lists + n_lists * L);
  int* counts = reinterpret_cast<int*>(lists + n_lists * L);
  int* grad_counts = counts + n_lists;
  float* red = reinterpret_cast<float*>(grad_counts + n_lists);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1-2. the forward's lists (tap indices here), and for the RoI gradient
  //      the lists of every live sample's taps with their coefficients
  {
    const int gmax = max(geo.gh, geo.gw);
    const int i = lane & 15;
    for (int q0 = 0; q0 < n_lists; q0 += 2 * warps) {
      const int q = q0 + 2 * warp + ((lane & 16) >> 4);
      const bool is_x = q >= p.out_h;
      const int idx = is_x ? q - p.out_h : q;
      const int g = q < n_lists ? (is_x ? geo.gw : geo.gh) : 0;
      const int size = is_x ? geo.W : geo.H;
      const roi_align::ListTaps t = roi_align::list_taps(
          is_x ? geo.x1 : geo.y1, idx, is_x ? geo.bin_w : geo.bin_h, g, size, gmax,
          is_x ? 1.f : geo.avg, lane);   // the average folds into the rows
      if (q < n_lists) {
        Entry* list = lists + q * L;
        if (t.own0) list[t.slot0] = Entry{t.t0, t.s0};
        if (t.own1) list[t.slot1] = Entry{t.t1, t.s1};
        if (i == 0) counts[q] = t.count;
      }
      if (p.grad_rois != nullptr) {
        float coef = 0.f, a = 0.f, w0 = 0.f, w1 = 0.f;
        if (t.live) {
          const float top = (float)size - 1.f;
          if (t.valid && t.t1 != t.t0) {
            const float cm = fmaxf(t.c, 0.f);
            coef = (t.c > 0.f ? 1.f : t.c == 0.f ? 0.5f : 0.f) *
                   (cm < top ? 1.f : cm == top ? 0.5f : 0.f);
          }
          a = ((float)idx + ((float)i + 0.5f) / (float)g) / (float)(is_x ? p.out_w : p.out_h);
          // the sample's two tap weights, as list_taps rounds them
          const float cc = fminf(fmaxf(t.c, 0.f), top);
          const float lo = cc - floorf(cc);
          const float scale = is_x ? 1.f : geo.avg;
          w0 = t.valid ? (1.f - lo) * scale : 0.f;
          w1 = t.valid ? lo * scale : 0.f;
        }
        // the average folds into the rows' coefficients too
        const int count = grad_list(t, coef, a, w0, w1, is_x ? 1.f : geo.avg, g, gmax, lane,
                                    grad_lists + (q < n_lists ? q : 0) * L);
        if (q < n_lists && i == 0) grad_counts[q] = count;
      }
    }
  }
  __syncthreads();

  // 3. the lists, key and rectangle, for the tile kernel
  if (p.lists != nullptr && blockIdx.y == 0) {
    Entry* dst = p.lists + r * n_lists * L;
    for (int e = threadIdx.x; e < n_lists * L; e += blockDim.x) {
      const int q = e / L;
      dst[e] = e - q * L < counts[q] ? lists[e] : Entry{-1, 0.f};
    }
    if (warp == 0) {
      int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
      for (int q = lane; q < n_lists; q += 32) {
        for (int e = 0; e < counts[q]; ++e) {
          const int t = lists[q * L + e].tap;
          if (q < p.out_h) {
            ylo = min(ylo, t);
            yhi = max(yhi, t);
          } else {
            xlo = min(xlo, t);
            xhi = max(xhi, t);
          }
        }
      }
      ylo = __reduce_min_sync(kFull, ylo);
      yhi = __reduce_max_sync(kFull, yhi);
      xlo = __reduce_min_sync(kFull, xlo);
      xhi = __reduce_max_sync(kFull, xhi);
      if (lane == 0) {
        // a RoI with no live row or no live column reaches no cell
        p.rects[r] = yhi < 0 || xhi < 0 ? make_int4(0, 0, 0, 0)
                                        : make_int4(ylo, yhi + 1, xlo, xhi + 1);
        p.keys[r] = geo.b * pyr.levels + lvl;
      }
    }
  }
  if (p.grad_rois == nullptr && p.live == nullptr) return;

  // 4. d rois over this block's bins (or, without, only whether their
  //    output gradient is zero)
  const int bins = p.out_h * p.out_w;
  const int nvec = p.channels / V;
  const int C = p.channels;
  const char* img = static_cast<const char*>(pyr.ptr[lvl]) +
                    (long long)geo.b * pyr.batch_stride[lvl] * (long long)sizeof(T);
  const long long rstride = pyr.row_stride[lvl] * (long long)sizeof(T);
  const long long cstride = pyr.col_stride[lvl] * (long long)sizeof(T);
  const char* gout = static_cast<const char*>(p.grad_out) + r * bins * C * (long long)sizeof(T);
  float acc_x1 = 0.f, acc_y1 = 0.f, acc_x2 = 0.f, acc_y2 = 0.f;
  bool live = false;

  for (int bin_id = blockIdx.y * warps + warp; bin_id < bins; bin_id += gridDim.y * warps) {
    const int ph = bin_id / p.out_w, pw = bin_id % p.out_w;
    const GradEntry* ys = grad_lists + ph * L;
    const GradEntry* xs = grad_lists + (p.out_h + pw) * L;
    const int ny = grad_counts[ph], nx = grad_counts[p.out_h + pw];
    for (int cv = lane; cv < nvec; cv += 32) {
      float g[V];
      Vec<T>::load(gout + ((long long)bin_id * C + cv * V) * (long long)sizeof(T), g);
      bool nonzero = false;
#pragma unroll
      for (int e = 0; e < V; ++e) nonzero = nonzero || g[e] != 0.f;
      live = live || nonzero;
      // a bin whose output gradient is zero adds exact zeros
      if (p.grad_rois == nullptr || !__any_sync(__activemask(), nonzero)) continue;
      const char* chan = img + cv * 16;
      // each tap (row a, column c) of the bin once: <g, F[a, c]> moves the
      // y edges by its row's coefficients times its column's weight, the x
      // edges by its row's weight (which holds the average) times its
      // column's coefficients
      for (int a = 0; a < ny; ++a) {
        const GradEntry y = ys[a];
        const char* row = chan + y.tap * rstride;
        for (int c = 0; c < nx; ++c) {
          const GradEntry x = xs[c];
          const float u1 = y.c1 * x.w, u2 = y.c2 * x.w, u3 = y.w * x.c1, u4 = y.w * x.c2;
          if (u1 == 0.f && u2 == 0.f && u3 == 0.f && u4 == 0.f) continue;
          float f[V];
          Vec<T>::load(row + x.tap * cstride, f);
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) dot = __fmaf_rn(g[e], f[e], dot);
          acc_y1 = __fmaf_rn(u1, dot, acc_y1);
          acc_y2 = __fmaf_rn(u2, dot, acc_y2);
          acc_x1 = __fmaf_rn(u3, dot, acc_x1);
          acc_x2 = __fmaf_rn(u4, dot, acc_x2);
        }
      }
    }
  }

  // the RoI's four sums over this block's bins: warps, then the block
  float v[4] = {acc_x1, acc_y1, acc_x2, acc_y2};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(kFull, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[warp * 4 + k] = v[k];
  }
  // a RoI whose output gradient is zero adds exact zeros to the levels: the
  // bucket sort leaves it out
  const int any_live = __syncthreads_or(live);
  if (p.live != nullptr && threadIdx.x == 0) p.live[(long long)blockIdx.y * p.n + r] = any_live;
  if (p.grad_rois != nullptr && threadIdx.x < 4) {
    float sum = 0.f;
    for (int w = 0; w < warps; ++w) sum += red[w * 4 + threadIdx.x];
    p.grad_rois[((long long)blockIdx.y * p.n + r) * 4 + threadIdx.x] = sum * geo.s;
  }
}

// ---- 2. the RoIs bucketed by key, in RoI order ------------------------------

// Two passes over the keys in chunks of the block: the first counts each
// key, the second places each RoI at its key's offset plus the RoIs of
// that key before it (earlier chunks, earlier warps, lower lanes). With
// `live` ((split, n) flags), a RoI with none set is left out.
__global__ void __launch_bounds__(kBucketThreads)
roi_align_backward_buckets_kernel(const int* __restrict__ keys, const int* __restrict__ live,
                                  int split, int n, int n_keys, int* __restrict__ order,
                                  int* __restrict__ offsets) {
  extern __shared__ int sm[];
  int* base = sm;                  // per key: RoIs so far (pass 0), next slot (pass 1)
  int* total = base + n_keys;      // per key: its RoIs in this chunk
  int* before = total + n_keys;    // (warp, key): its RoIs in the chunk's earlier warps
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < n_keys; k += blockDim.x) base[k] = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      __syncthreads();
      if (threadIdx.x == 0) {
        int s = 0;
        for (int k = 0; k < n_keys; ++k) {
          const int c = base[k];
          base[k] = s;
          offsets[k] = s;
          s += c;
        }
        offsets[n_keys] = s;
      }
    }
    for (int c0 = 0; c0 < n; c0 += blockDim.x) {
      const int i = c0 + threadIdx.x;
      bool kept = i < n;
      if (kept && live != nullptr) {
        kept = false;
        for (int s = 0; s < split; ++s) kept = kept || live[(long long)s * n + i] != 0;
      }
      const int key = kept ? keys[i] : -1;
      for (int k = threadIdx.x; k < warps * n_keys; k += blockDim.x) before[k] = 0;
      __syncthreads();
      const unsigned same = __match_any_sync(kFull, key);
      const int rank = __popc(same & ((1u << lane) - 1u));
      if (key >= 0 && rank == 0) before[warp * n_keys + key] = __popc(same);
      __syncthreads();
      for (int k = threadIdx.x; k < n_keys; k += blockDim.x) {
        int s = 0;
        for (int w = 0; w < warps; ++w) {
          const int c = before[w * n_keys + k];
          before[w * n_keys + k] = s;
          s += c;
        }
        total[k] = s;
      }
      __syncthreads();
      if (pass == 1 && key >= 0) order[base[key] + before[warp * n_keys + key] + rank] = i;
      __syncthreads();
      for (int k = threadIdx.x; k < n_keys; k += blockDim.x) base[k] += total[k];
    }
  }
}

// ---- 3. the level gradient, one tile of cells per block ---------------------

struct TileParams {
  void* grad[kMaxLevels];            // per level (B, H, W, C), levels' dtype
  long long first_block[kMaxLevels]; // the first block of each level
  int height[kMaxLevels], width[kMaxLevels], tiles_x[kMaxLevels];
  const void* grad_out;
  const Entry* lists;
  const int4* rects;
  const int* order;
  const int* offsets;
  int levels, channels, out_h, out_w, max_ratio, slices;
};

// A block's work on a group of the RoIs that meet its tile (up to kGroup,
// in order): their lists turned into weight tables, the tile rows' weight
// in each bin row (wy) and the tile columns' weight in each bin column
// (wx); then the output gradient of the bins that reach the tile, hit by
// hit, staged in shared memory kStageBytes at a time; each warp then adds
// its row's cells. A group costs a few waits on memory, whatever its size.
constexpr int kGroup = 8;
constexpr int kStageBytes = 32 * 1024;  // the output gradient staged a round
constexpr int kMaxEntries = 8;       // list entries a thread stages: kMaxEntries x 256 a group

template <typename T>
struct TileShared {
  // 16-byte vectors of a lane's channels, and bins staged a round
  static constexpr int kParts = kLaneChannels / Vec<T>::kWidth;
  static constexpr int kBins = kStageBytes / (kParts * 32 * 16);
  int hits[kTileRows * 32];
  int found[kTileRows];
  int ph0[kGroup], nph[kGroup], pw0[kGroup], npw[kGroup];
  float wy[kGroup][kTileRows][kMaxOutW];   // (hit, tile row, bin row)
  float wx[kGroup][kMaxOutW][kTileCols];   // (hit, bin column, tile column)
  uint4 g[kBins][kParts][32];              // (staged bin, vector, lane): the slice's bytes
};

// three blocks per SM at least: the kernel waits on loads, and a fourth of
// its sums in registers leaves room for them
template <typename T>
__global__ void __launch_bounds__(kTileRows * 32, 3)
roi_align_backward_levels_kernel(const TileParams p) {
  constexpr int V = Vec<T>::kWidth;
  constexpr int TW = kTileCols;
  constexpr int kParts = TileShared<T>::kParts;
  constexpr int kBins = TileShared<T>::kBins;
  extern __shared__ int4 tile_smem[];
  TileShared<T>& sh = *reinterpret_cast<TileShared<T>*>(tile_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the block's level, image, tile and channel slice: the level's values
  // picked with constant indices (a parameter array indexed at run time
  // would be copied to local memory)
  const long long bid = blockIdx.x;
  int lvl = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) lvl = l < p.levels && bid >= p.first_block[l] ? l : lvl;
  int H = 0, W = 0, tiles_x = 1;
  long long first = 0;
  char* out = nullptr;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l == lvl) {
      H = p.height[l];
      W = p.width[l];
      tiles_x = p.tiles_x[l];
      first = p.first_block[l];
      out = static_cast<char*>(p.grad[l]);
    }
  }
  long long local = bid - first;
  const int slice = (int)(local % p.slices);
  local /= p.slices;
  const int tile_x = (int)(local % tiles_x);
  local /= tiles_x;
  const int tiles_y = (H + kTileRows - 1) / kTileRows;
  const int tile_y = (int)(local % tiles_y);
  const int b = (int)(local / tiles_y);
  const int y0 = tile_y * kTileRows, x0 = tile_x * TW;
  const int y = y0 + warp;
  const int C = p.channels;
  const int nvec = C / V;                     // 16-byte vectors of a bin
  // this lane's vectors: cv, cv + 32, ..., so that each store of a warp is
  // 512 contiguous bytes
  const int cv = slice * 32 * kParts + lane;
  const int L = 2 * p.max_ratio;
  const int n_rows = p.out_h * L, n_entries = (p.out_h + p.out_w) * L;
  const long long bin_bytes = (long long)C * sizeof(T);

  float acc[TW][kLaneChannels];
#pragma unroll
  for (int k = 0; k < TW; ++k) {
#pragma unroll
    for (int e = 0; e < kLaneChannels; ++e) acc[k][e] = 0.f;
  }

  const int key = b * p.levels + lvl;
  const int start = p.offsets[key], end = p.offsets[key + 1];
  for (int c0 = start; c0 < end; c0 += blockDim.x) {
    // the bucket's RoIs whose rectangle meets the tile, in RoI order
    const int i = c0 + threadIdx.x;
    int r = 0;
    int4 rc = make_int4(0, 0, 0, 0);
    if (i < end) {
      r = p.order[i];
      rc = p.rects[r];
    }
    const bool hit = rc.x < y0 + kTileRows && rc.y > y0 && rc.z < x0 + TW && rc.w > x0;
    const unsigned m = __ballot_sync(kFull, hit);
    if (lane == 0) sh.found[warp] = __popc(m);
    __syncthreads();
    int slot = 0, n_hits = 0;
#pragma unroll
    for (int w = 0; w < kTileRows; ++w) {
      slot += w < warp ? sh.found[w] : 0;
      n_hits += sh.found[w];
    }
    if (hit) {
      slot += __popc(m & ((1u << lane) - 1u));
      sh.hits[slot] = r;
    }
    __syncthreads();

    const int group = max(1, min(kGroup, kMaxEntries * kTileRows * 32 / n_entries));
    for (int h0 = 0; h0 < n_hits; h0 += group) {
      const int ng = min(group, n_hits - h0);
      // 1. the weight tables, cleared, then an entry on a tile row or column
      //    at its bin
      for (int e = threadIdx.x; e < ng * kTileRows * kMaxOutW; e += blockDim.x) {
        (&sh.wy[0][0][0])[e] = 0.f;
      }
      for (int e = threadIdx.x; e < ng * kMaxOutW * TW; e += blockDim.x) (&sh.wx[0][0][0])[e] = 0.f;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kMaxEntries; ++u) {
        const int f = threadIdx.x + u * kTileRows * 32;     // (hit, entry) flat
        if (f < ng * n_entries) {
          const int j = f / n_entries, e = f - j * n_entries;
          const Entry x = load_entry(p.lists + (long long)sh.hits[h0 + j] * n_entries + e);
          if (x.tap >= 0) {
            if (e < n_rows) {
              if (x.tap >= y0 && x.tap < y0 + kTileRows) sh.wy[j][x.tap - y0][e / L] = x.weight;
            } else if (x.tap >= x0 && x.tap < x0 + TW) {
              sh.wx[j][(e - n_rows) / L][x.tap - x0] = x.weight;
            }
          }
        }
      }
      __syncthreads();
      // 2. each hit's bins whose row list meets the tile's rows and whose
      //    column list meets its columns (warp j takes hit j)
      if (warp < ng) {
        bool row_live = false, col_live = false;
        if (lane < p.out_h) {
#pragma unroll
          for (int t = 0; t < kTileRows; ++t) row_live = row_live || sh.wy[warp][t][lane] != 0.f;
        }
        if (lane < p.out_w) {
#pragma unroll
          for (int k = 0; k < TW; ++k) col_live = col_live || sh.wx[warp][lane][k] != 0.f;
        }
        const unsigned rows_m = __ballot_sync(kFull, row_live);
        const unsigned cols_m = __ballot_sync(kFull, col_live);
        if (lane == 0) {
          sh.ph0[warp] = __ffs(rows_m) - 1;
          sh.pw0[warp] = __ffs(cols_m) - 1;
          sh.nph[warp] = rows_m && cols_m ? 32 - __clz(rows_m) - (__ffs(rows_m) - 1) : 0;
          sh.npw[warp] = rows_m && cols_m ? 32 - __clz(cols_m) - (__ffs(cols_m) - 1) : 0;
        }
      }
      __syncthreads();
      int total = 0;
      for (int j = 0; j < ng; ++j) total += sh.nph[j] * sh.npw[j];
      for (int b0 = 0; b0 < total; b0 += kBins) {
        // 3. stage a chunk of the group's bins (this block's channel slice),
        //    hit by hit, each hit's bins row by row
        for (int e = threadIdx.x; e < kBins * kParts * 32; e += blockDim.x) {
          const int part = e % (kParts * 32), v = slice * 32 * kParts + part;
          int q = b0 + e / (kParts * 32), j = 0;
          while (j < ng && q >= sh.nph[j] * sh.npw[j]) {
            q -= sh.nph[j] * sh.npw[j];
            ++j;
          }
          if (j < ng && v < nvec) {
            const int ph = sh.ph0[j] + q / sh.npw[j], pw = sh.pw0[j] + q % sh.npw[j];
            sh.g[e / (kParts * 32)][part / 32][part % 32] =
                __ldg(reinterpret_cast<const uint4*>(
                static_cast<const char*>(p.grad_out) +
                (((long long)sh.hits[h0 + j] * p.out_h + ph) * p.out_w + pw) * bin_bytes +
                (long long)v * 16));
          }
        }
        __syncthreads();
        // 4. this warp's row: w_row * w_col * g into each cell, in order,
        //    over the bins of the chunk whose row list holds the row
        if (y < H) {
          const int b1 = min(b0 + kBins, total);
          int first = 0;                          // the hit's first bin in the group
          for (int j = 0; j < ng; ++j) {
            const int ph0 = sh.ph0[j], nph = sh.nph[j], pw0 = sh.pw0[j], npw = sh.npw[j];
            const int last = first + nph * npw;
            if (last > b0 && first < b1) {
              unsigned rows_m = __ballot_sync(kFull, lane < p.out_h && sh.wy[j][warp][lane] != 0.f);
              while (rows_m) {
                const int ph = __ffs(rows_m) - 1;
                rows_m &= rows_m - 1;
                const int q0 = first + (ph - ph0) * npw;
                if (q0 + npw <= b0 || q0 >= b1) continue;
                const float wy = sh.wy[j][warp][ph];
                for (int pw = pw0; pw < pw0 + npw; ++pw) {
                  const int q = q0 + pw - pw0;
                  if (q < b0 || q >= b1) continue;
                  float g[kLaneChannels];
#pragma unroll
                  for (int u = 0; u < kParts; ++u) Vec<T>::unpack(sh.g[q - b0][u][lane], g + u * V);
                  const float* w = sh.wx[j][pw];
#pragma unroll
                  for (int k = 0; k < TW; ++k) {
                    const float wk = w[k];
                    if (wk != 0.f) {
                      const float f = wy * wk;
#pragma unroll
                      for (int e = 0; e < kLaneChannels; ++e) {
                        acc[k][e] = __fmaf_rn(f, g[e], acc[k][e]);
                      }
                    }
                  }
                }
              }
            }
            first = last;
          }
        }
        __syncthreads();
      }
    }
  }

  if (y < H) {
    char* dst = out + (((long long)b * H + y) * W * C + (long long)cv * V) * (long long)sizeof(T);
#pragma unroll
    for (int k = 0; k < TW; ++k) {
#pragma unroll
      for (int u = 0; u < kParts; ++u) {
        if (x0 + k < W && cv + 32 * u < nvec) {
          Vec<T>::store(dst + ((long long)(x0 + k) * C + 32 * u * V) * (long long)sizeof(T),
                        acc[k] + u * V);
        }
      }
    }
  }
}

// The tile kernel's launch, with its shared memory allowed above the 48 KB
// that needs no opt-in (on the current device).
template <typename T>
int launch_levels(const TileParams& p, long long blocks, cudaStream_t s) {
  const int smem = (int)sizeof(TileShared<T>);
  const cudaError_t allowed = cudaFuncSetAttribute(
      roi_align_backward_levels_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  roi_align_backward_levels_kernel<T><<<(unsigned)blocks, kTileRows * 32, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// The per-RoI launch: the forward's warps per block, and bins dealt over
// blockIdx.y until the grid holds about 80 warps per SM (the SM holds 64).
void launch_shape(int n, int out_h, int out_w, int* warps, int* split) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *warps = roi_align::block_warps(out_h, out_w, kMaxWarps);
  const int rounds = (out_h * out_w + *warps - 1) / *warps;
  const long long want = 80LL * sms, have = (long long)n * *warps;
  const long long fill = (want + have - 1) / have;
  *split = fill < 1 ? 1 : fill > rounds ? rounds : (int)fill;
}

size_t smem_bytes(int out_h, int out_w, int max_ratio, int warps) {
  return (size_t)(out_h + out_w) *
             (2 * max_ratio * (sizeof(Entry) + sizeof(GradEntry)) + 2 * sizeof(int)) +
         4 * warps * sizeof(float);
}

void fill_pyramid(Pyramid* pyr, int levels, const void* const* level_ptrs,
                  const long long* level_dims, const float* inv_strides) {
  for (int l = 0; l < levels; ++l) {
    pyr->ptr[l] = level_ptrs[l];
    pyr->height[l] = (int)level_dims[5 * l + 0];
    pyr->width[l] = (int)level_dims[5 * l + 1];
    pyr->batch_stride[l] = level_dims[5 * l + 2];
    pyr->row_stride[l] = level_dims[5 * l + 3];
    pyr->col_stride[l] = level_dims[5 * l + 4];
    pyr->inv_stride[l] = inv_strides[l];
  }
  pyr->levels = levels;
}

}  // namespace

// The per-RoI kernel's launch shape: threads per block / 32 and blocks per
// RoI along blockIdx.y (the first dimension of grad_rois). 0 on success.
extern "C" int roi_align_backward_shape(int n, int out_h, int out_w, int* warps, int* split) {
  if (n <= 0 || out_h < 1 || out_w < 1) return (int)cudaErrorInvalidValue;
  launch_shape(n, out_h, out_w, warps, split);
  return 0;
}

// The tile kernel's tile in one dtype: rows, cells per row, and channels
// per block (one slice).
extern "C" int roi_align_backward_tile(int is_bf16, int* rows, int* cols, int* channels) {
  (void)is_bf16;
  *rows = kTileRows;
  *cols = kTileCols;
  *channels = 32 * kLaneChannels;
  return 0;
}

// level_dims, inv_strides, rois, n, batch, channels, out_h, out_w,
// max_ratio, finest_scale and span_limit as roi_align_forward's; grad_out
// is (n, out_h, out_w, C) contiguous in the levels' dtype. grad_rois
// receives (split, n, 4) partial sums, split from roi_align_backward_shape
// (null: no RoI gradient, one block per RoI); lists ((n, out_h + out_w,
// 2 max_ratio) entries of 8 bytes), rects ((n, 4) int32) and keys ((n,)
// int32) the tile kernel's inputs (all null: none); live ((split, n)
// int32, or null) whether each block's bins have a nonzero output
// gradient, for the bucket sort. Launches on `stream`,
// allocates nothing, does not synchronise, and returns the cudaError_t of
// the launch (0 on success).
extern "C" int roi_align_backward_rois(int is_bf16, int levels, const void* const* level_ptrs,
                                       const long long* level_dims, const float* inv_strides,
                                       const void* rois, const void* grad_out, float* grad_rois,
                                       int* live, void* lists, void* rects, int* keys, int n,
                                       int batch,
                                       int channels, int out_h, int out_w, int max_ratio,
                                       float finest_scale, float span_limit, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0 || max_ratio < 1 || max_ratio > kMaxRatio ||
      (lists == nullptr) != (rects == nullptr) || (lists == nullptr) != (keys == nullptr) ||
      (live != nullptr && grad_out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr{};
  fill_pyramid(&pyr, levels, level_ptrs, level_dims, inv_strides);
  RoIParams p{};
  p.rois = static_cast<const float*>(rois);
  p.grad_out = grad_out;
  p.grad_rois = grad_rois;
  p.live = live;
  p.lists = static_cast<Entry*>(lists);
  p.rects = static_cast<int4*>(rects);
  p.keys = keys;
  p.n = n;
  p.batch = batch;
  p.channels = channels;
  p.out_h = out_h;
  p.out_w = out_w;
  p.max_ratio = max_ratio;
  p.finest_scale = finest_scale;
  p.span_limit = span_limit;

  int warps = 0, split = 1;
  launch_shape(n, out_h, out_w, &warps, &split);
  if (grad_rois == nullptr) split = 1;
  const size_t smem = smem_bytes(out_h, out_w, max_ratio, warps);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, (unsigned)split);
  const dim3 block(warps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_backward_rois_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(pyr, p);
  } else {
    roi_align_backward_rois_kernel<float><<<grid, block, smem, s>>>(pyr, p);
  }
  return (int)cudaGetLastError();
}

// keys (n,) in [0, n_keys) -> order: the RoIs by key, in RoI order within
// a key; offsets (n_keys + 1,): each key's first place in order. With live
// ((split, n) from roi_align_backward_rois, or null) the RoIs whose output
// gradient is zero are left out (offsets[n_keys] counts the others).
extern "C" int roi_align_backward_buckets(const int* keys, const int* live, int split, int n,
                                          int n_keys, int* order, int* offsets, void* stream) {
  if (n <= 0 || n_keys < 1 || n_keys > kMaxKeys || split < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 + kBucketThreads / 32) * n_keys * sizeof(int);
  roi_align_backward_buckets_kernel<<<1, kBucketThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      keys, live, split, n, n_keys, order, offsets);
  return (int)cudaGetLastError();
}

// grad_ptrs[l]: level l's gradient (B, H_l, W_l, C) contiguous in the
// levels' dtype, level_hw[2 l], [2 l + 1] its H_l, W_l; every cell is
// written. lists, rects from roi_align_backward_rois, order and offsets
// from roi_align_backward_buckets (keys image * levels + level); grad_out
// as there; out_h, out_w <= 32.
extern "C" int roi_align_backward_levels(int is_bf16, int levels, void* const* grad_ptrs,
                                         const long long* level_hw, const void* grad_out,
                                         const void* lists, const void* rects, const int* order,
                                         const int* offsets, int batch, int channels, int out_h,
                                         int out_w, int max_ratio, void* stream) {
  const int v = is_bf16 ? Vec<__nv_bfloat16>::kWidth : Vec<float>::kWidth;
  if (levels < 1 || levels > kMaxLevels || batch < 1 || channels % v || out_h < 1 ||
      out_w < 1 || out_w > kMaxOutW || out_h > kMaxOutW || max_ratio < 1 ||
      max_ratio > kMaxRatio ||
      (out_h + out_w) * 2 * max_ratio > kMaxEntries * kTileRows * 32) {
    return (int)cudaErrorInvalidValue;
  }
  TileParams p{};
  const int tw = kTileCols;
  p.slices = (channels + 32 * kLaneChannels - 1) / (32 * kLaneChannels);
  long long blocks = 0;
  for (int l = 0; l < levels; ++l) {
    p.grad[l] = grad_ptrs[l];
    p.height[l] = (int)level_hw[2 * l];
    p.width[l] = (int)level_hw[2 * l + 1];
    p.tiles_x[l] = (p.width[l] + tw - 1) / tw;
    p.first_block[l] = blocks;
    blocks += (long long)batch * ((p.height[l] + kTileRows - 1) / kTileRows) * p.tiles_x[l] *
              p.slices;
  }
  for (int l = levels; l < kMaxLevels; ++l) p.first_block[l] = blocks;
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  p.grad_out = grad_out;
  p.lists = static_cast<const Entry*>(lists);
  p.rects = static_cast<const int4*>(rects);
  p.order = order;
  p.offsets = offsets;
  p.levels = levels;
  p.channels = channels;
  p.out_h = out_h;
  p.out_w = out_w;
  p.max_ratio = max_ratio;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_levels<__nv_bfloat16>(p, blocks, s);
  }
  return launch_levels<float>(p, blocks, s);
}

// Registers per thread and local memory per thread (spills and stack) of
// one backward kernel (0 the per-RoI kernel, 1 the bucket sort, 2 the tile
// kernel) in one dtype, as the loaded build reports them.
extern "C" int roi_align_backward_attributes(int kernel, int is_bf16, int* registers,
                                             int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  if (kernel == 0) {
    e = is_bf16 ? cudaFuncGetAttributes(&a, roi_align_backward_rois_kernel<__nv_bfloat16>)
                : cudaFuncGetAttributes(&a, roi_align_backward_rois_kernel<float>);
  } else if (kernel == 1) {
    e = cudaFuncGetAttributes(&a, roi_align_backward_buckets_kernel);
  } else if (kernel == 2) {
    e = is_bf16 ? cudaFuncGetAttributes(&a, roi_align_backward_levels_kernel<__nv_bfloat16>)
                : cudaFuncGetAttributes(&a, roi_align_backward_levels_kernel<float>);
  }
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* roi_align_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
