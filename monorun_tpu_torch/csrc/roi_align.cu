// Multilevel aligned RoIAlign, forward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels
//   monorun_tpu/ops/roi_align_band.py:_band_kernel     (proposal scale)
//   monorun_tpu/ops/roi_align_sorted.py:_sorted_kernel (detection scale)
// which both compute monorun_tpu/ops/roi_align.py:multilevel_roi_align with
// sampling_ratio=0, a max_ratio cap and the long-span level cap. The plain
// PyTorch version it is held to is
// monorun_tpu_torch/ops/roi_align.py:multilevel_roi_align.
//
// Function: for every RoI (batch, x1, y1, x2, y2 in image pixels) pick its
// FPN level (mmdet area rule, pushed coarser until the long side spans at
// most span_limit pixels, clamped to the pyramid), scale and shift it by
// -0.5, and average a ceil(bin) x ceil(bin) grid (capped at max_ratio) of
// bilinear samples per output bin. Samples outside [-1, size] add zero; the
// others clamp into the map and the far tap clamps to the last row/column.
// Inputs are the NHWC levels as they lie in memory (pointer, shape and
// element strides per level, unit channel stride), float32 or bfloat16;
// accumulation is float32; the output is (n, out_h, out_w, C) in the input
// dtype.
//
// Bound on an H100: bytes (the distinct feature rows the taps touch, plus
// the output), but a straightforward kernel is held back by instruction
// issue first: 4 tap loads per sample, half of them repeats of the sample
// before, each unpacked and weighted channel by channel.
//
// Design: one block per RoI (split over blockIdx.y into groups of bins
// when there are too few RoIs to fill the SMs), one warp per output bin,
// the lanes across the channels, each owning a 16-byte vector (8 bf16 or
// 4 fp32 channels), so every tap is a coalesced 16-byte load of a
// contiguous NHWC row and every bin one streaming 16-byte store per lane.
// The bilinear weight of a sample factorises, w = wy(row) * wx(column),
// with validity vy && vx, so a bin is sum_r Ay[r] sum_c Ax[c] F[r, c] over
// its distinct tap rows and columns (the hat-function form of the TPU band
// kernel's X @ (Y @ tile), per bin and over the bin's own taps). The row
// list depends on the bin's row only, the column list on its column, so a
// block builds the out_h + out_w lists of its RoI once, in shared memory:
//   1. each half warp takes one list; lane i computes sample i along its
//      axis (kMaxRatio samples at most), with exactly the plain version's
//      coordinate arithmetic;
//   2. each lane's two taps (near and far) are merged by warp shuffles with
//      every tap of the list on the same row or column: the first holds
//      the sum of their weights, the others drop out, and so do taps whose
//      merged weight is zero (samples outside [-1, size], an exact integer
//      coordinate); the far tap clamped onto the near one merges into it.
//      The 1/(gh*gw) average folds into the rows. Survivors are compacted
//      by ballot into (byte offset, weight) entries;
//   3. after the block's one barrier, each warp walks its bin's row list
//      and column list two entries of each at a time (four loads in
//      flight): one load and one fused multiply-add per channel for each
//      distinct tap.
// Launch shape: warps per block a multiple of 4, so each of the SM's four
// schedulers holds the same share of every block (7 warps at 7x7, which
// leave no warp idle in a block's last round, measured 5-7 % slower than 8
// warps at 8000 RoIs on an H100), and enough warps to build every list in
// one pass (8 at 7x7, 16 at 14x14). With few RoIs the bins of a RoI are
// dealt over blockIdx.y until the grid holds about 1.25 times the warps
// the SMs hold at once.
// Nothing is allocated and nothing is prepared on the host; the per-RoI
// geometry (roi_align_geometry.cuh, shared with the backward kernel
// roi_align_bwd.cu) is a few scalar operations every thread recomputes. The TPU
// staging (flat padded pyramid, tile DMAs, band bucketing) has no
// counterpart. Output stores bypass the L2's normal retention
// (st.global.cs) so the large proposal output does not push the pyramid's
// taps out of the cache.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -shared -Xcompiler -fPIC (monorun_tpu_torch/ops/roi_align_cuda.py).
// -fmad=false keeps every coordinate, grid-size and weight operation
// rounding like the plain version's separate tensor operations (a one-ulp
// change in ceil(roi_w / out_w) changes a sample grid); the channel sums
// use explicit __fmaf_rn, which the flag does not forbid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using roi_align::kMaxLevels;
using roi_align::kMaxRatio;
using roi_align::Pyramid;

constexpr int kMaxWarps = 16;
// blocks of kMaxWarps per SM that ptxas must fit: 64 registers per thread,
// so 32 warps per SM at 7x7 (4 blocks of 8); float32 at 88 registers, 16
// warps, measured about 20 % slower on an H100
constexpr int kMinBlocks = 2;

struct Params {
  const float* rois;
  void* out;
  int batch, channels, out_h, out_w, max_ratio;
  float finest_scale, span_limit;
};

template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kWidth = 4;
  using Raw = float4;
  __device__ static Raw load(const char* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void fma(const Raw& q, float w, float* acc) {
    acc[0] = __fmaf_rn(w, q.x, acc[0]);
    acc[1] = __fmaf_rn(w, q.y, acc[1]);
    acc[2] = __fmaf_rn(w, q.z, acc[2]);
    acc[3] = __fmaf_rn(w, q.w, acc[3]);
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  using Raw = uint4;
  __device__ static Raw load(const char* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  // element 2i is the low half of word i; a bfloat16 is the high half of
  // its float32
  __device__ static void fma(const Raw& q, float w, float* acc) {
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = __fmaf_rn(w, __uint_as_float(u[i] << 16), acc[2 * i]);
      acc[2 * i + 1] = __fmaf_rn(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), q);
  }
};

// The lists of one RoI, in dynamic shared memory: for every output row
// (lists 0..out_h-1) and column (out_h..out_h+out_w-1), up to 2*max_ratio
// entries of (byte offset of the tap row or column, merged weight),
// then the entry count of every list.
struct Entry {
  int offset;
  float weight;
};

// R consecutive rows of a bin's row list against its whole column list,
// columns two at a time: all 2R loads are issued before the first
// multiply-add that uses them
template <typename T, int R>
__device__ __forceinline__ void walk_rows(const char* chan, const Entry* ys, const Entry* xs,
                                          int nx, float* acc) {
  using Raw = typename Pack<T>::Raw;
  const char* row[R];
  float wy[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = chan + ys[i].offset;
    wy[i] = ys[i].weight;
  }
  int c = 0;
  for (; c + 1 < nx; c += 2) {
    const int4 pair = *reinterpret_cast<const int4*>(xs + c);
    Raw q[R][2];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      q[i][0] = Pack<T>::load(row[i] + pair.x);
      q[i][1] = Pack<T>::load(row[i] + pair.z);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      Pack<T>::fma(q[i][0], wy[i] * __int_as_float(pair.y), acc);
      Pack<T>::fma(q[i][1], wy[i] * __int_as_float(pair.w), acc);
    }
  }
  if (c < nx) {
    const Entry x = xs[c];
    Raw q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) q[i] = Pack<T>::load(row[i] + x.offset);
#pragma unroll
    for (int i = 0; i < R; ++i) Pack<T>::fma(q[i], wy[i] * x.weight, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
roi_align_forward_kernel(const Pyramid pyr, const Params p) {
  constexpr int V = Pack<T>::kWidth;
  extern __shared__ int4 smem[];
  const long long r = blockIdx.x;
  const roi_align::RoIGeometry geo = roi_align::roi_geometry(
      p.rois + 5 * r, pyr, p.batch, p.out_h, p.out_w, p.max_ratio, p.finest_scale,
      p.span_limit);
  const int b = geo.b, lvl = geo.lvl, gw = geo.gw, gh = geo.gh;

  const int L = 2 * p.max_ratio;                  // entries per list
  const int n_lists = p.out_h + p.out_w;
  Entry* lists = reinterpret_cast<Entry*>(smem);
  int* counts = reinterpret_cast<int*>(lists + n_lists * L);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1-2. every list of the RoI, one per half warp: lane i of the half
  //      computes sample i along the list's axis, with exactly the plain
  //      version's arithmetic, and merges its two taps with every tap of
  //      the list on the same row/column, in tap order (near, far of
  //      sample 0, near, far of sample 1, ...): the first tap holds the sum
  {
    const int gmax = max(gh, gw);
    for (int q0 = 0; q0 < n_lists; q0 += 2 * warps) {
      const int q = q0 + 2 * warp + ((lane & 16) >> 4);
      const bool is_x = q >= p.out_h;
      const roi_align::ListTaps t = roi_align::list_taps(
          is_x ? geo.x1 : geo.y1, is_x ? q - p.out_h : q, is_x ? geo.bin_w : geo.bin_h,
          q < n_lists ? (is_x ? gw : gh) : 0, is_x ? geo.W : geo.H, gmax,
          is_x ? 1.f : geo.avg, lane);   // the average folds into the rows
      if (q < n_lists) {
        const int stride = (int)(is_x ? pyr.col_stride[lvl] : pyr.row_stride[lvl]) * sizeof(T);
        Entry* list = lists + q * L;
        if (t.own0) list[t.slot0] = Entry{t.t0 * stride, t.s0};
        if (t.own1) list[t.slot1] = Entry{t.t1 * stride, t.s1};
        if ((lane & 15) == 0) counts[q] = t.count;
      }
    }
  }
  __syncthreads();

  // 3. the bins: one load and one fused multiply-add per channel for each
  //    distinct tap
  const char* base = static_cast<const char*>(pyr.ptr[lvl]) +
                     b * pyr.batch_stride[lvl] * (long long)sizeof(T);
  const int bins = p.out_h * p.out_w;
  const int nvec = p.channels / V;
  T* out = static_cast<T*>(p.out) + r * bins * p.channels;
  // the bin's row and column packed as row << 16 | column (out_h + out_w
  // is below 2458, see the launch), and the step packed the same way: one
  // register each, which keeps float32 within 64 without a spill
  const int step = gridDim.y * warps;
  const int step_hw = (step / p.out_w) << 16 | step % p.out_w;
  int bin_id = blockIdx.y * warps + warp;
  int hw = (bin_id / p.out_w) << 16 | bin_id % p.out_w;
  for (; bin_id < bins; bin_id += step) {
    const int ph = hw >> 16, pw = hw & 0xffff;
    const Entry* ys = lists + ph * L;
    const Entry* xs = lists + (p.out_h + pw) * L;
    const int ny = counts[ph], nx = counts[p.out_h + pw];
    T* dst = out + (long long)bin_id * p.channels;
    for (int cv = lane; cv < nvec; cv += 32) {
      const char* chan = base + cv * 16;
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      // rows two at a time (four loads in flight), then a lone last row
      int a = 0;
      for (; a + 1 < ny; a += 2) walk_rows<T, 2>(chan, ys + a, xs, nx, acc);
      if (a < ny) walk_rows<T, 1>(chan, ys + a, xs, nx, acc);
      Pack<T>::store(dst + cv * V, acc);
    }
    hw += step_hw;
    if ((hw & 0xffff) >= p.out_w) hw += (1 << 16) - p.out_w;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// level_dims holds, per level: height, width, batch, row and column strides
// (in elements); a tap's byte offset within one image of a level,
// ((H-1)*row + (W-1)*col + channels) * element size, must fit an int. span_limit <= 0
// disables the long-side cap. max_ratio is at most 16, and the lists,
// (out_h + out_w) * (16 * max_ratio + 4) bytes, at most 48 KB. Launches
// on `stream`, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int roi_align_forward(int is_bf16, int levels, const void* const* level_ptrs,
                                 const long long* level_dims, const float* inv_strides,
                                 const void* rois, void* out, int n, int batch, int channels,
                                 int out_h, int out_w, int max_ratio, float finest_scale,
                                 float span_limit, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0 || max_ratio < 1 || max_ratio > kMaxRatio) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr{};
  for (int l = 0; l < levels; ++l) {
    pyr.ptr[l] = level_ptrs[l];
    pyr.height[l] = (int)level_dims[5 * l + 0];
    pyr.width[l] = (int)level_dims[5 * l + 1];
    pyr.batch_stride[l] = level_dims[5 * l + 2];
    pyr.row_stride[l] = level_dims[5 * l + 3];
    pyr.col_stride[l] = level_dims[5 * l + 4];
    pyr.inv_stride[l] = inv_strides[l];
  }
  pyr.levels = levels;
  Params p{static_cast<const float*>(rois), out, batch, channels, out_h, out_w,
           max_ratio, finest_scale, span_limit};

  // warps: a multiple of 4, at least half the list count (one list per
  // half warp, so one pass builds them all); split: the least share of a
  // RoI's rounds per block that puts 80 warps per SM in the grid (the SM
  // holds 64)
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int bins = out_h * out_w;
  const int warps = roi_align::block_warps(out_h, out_w, kMaxWarps);
  const int rounds = (bins + warps - 1) / warps;
  const long long want = 80LL * sms, have = (long long)n * warps;
  const long long fill = (want + have - 1) / have;
  const int split = fill < 1 ? 1 : fill > rounds ? rounds : (int)fill;
  const size_t smem = (size_t)(out_h + out_w) * (2 * max_ratio * sizeof(Entry) + sizeof(int));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;

  const dim3 grid((unsigned)n, (unsigned)split);
  const dim3 block(warps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_forward_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(pyr, p);
  } else {
    roi_align_forward_kernel<float><<<grid, block, smem, s>>>(pyr, p);
  }
  return (int)cudaGetLastError();
}

// One launch of an empty kernel on `stream`: the fixed cost of a launch in
// the same timing harness as the forward.
extern "C" int roi_align_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Registers per thread and local memory per thread (spills and stack) of
// the forward kernel in one dtype, as the loaded build reports them.
extern "C" int roi_align_attributes(int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      is_bf16 ? cudaFuncGetAttributes(&a, roi_align_forward_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&a, roi_align_forward_kernel<float>);
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
