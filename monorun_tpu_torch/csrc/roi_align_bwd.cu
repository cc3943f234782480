// Multilevel aligned RoIAlign, backward, for Hopper (sm_90a).
//
// The gradient of the direct kernel (roi_align.cu), which replaces the TPU
// kernels monorun_tpu/ops/roi_align_sorted.py:_sorted_kernel (every align
// of the training step) and roi_align_band.py:_band_kernel. The JAX
// package differentiates monorun_tpu/ops/roi_align.py:multilevel_roi_align
// with jax.grad; the plain PyTorch version this kernel is held to is
// autograd through monorun_tpu_torch/ops/roi_align.py:multilevel_roi_align.
//
// Function: given the output gradient g (n, out_h, out_w, C), in the
// features' dtype,
//   d level: for every RoI, bin and sample, g times each bilinear weight
//     times 1/(gh*gw), added into that sample's taps in the RoI's level;
//     float32, into one zeroed scratch that holds every level contiguous
//     (B, H_l, W_l, C);
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
// Design: the forward's launch (one block per RoI, its bins dealt over
// blockIdx.y when there are few RoIs, one warp per bin, each lane a 16-byte
// channel vector) and its per-row and per-column lists of distinct taps
// with merged weights (roi_align_geometry.cuh), built once per block in
// shared memory together with each sample's taps and coordinate
// derivative. Then per bin:
//   d level: each distinct tap (row r, column c) takes w_r w_c g as one
//     vector atomic add per 4 channels, not four adds per sample;
//   d rois: the bilinear weight factorises, so the derivative along y of
//     sample k of the bin's row is coef_k sum_c w_c <g, F[t1_k, c] -
//     F[t0_k, c]> over the bin's merged columns (and likewise along x over
//     its merged rows); each lane keeps its channels' share of the four
//     sums, and the block reduces them once, without atomics.
// A simple kernel: the RoI gradient reloads two taps per (sample, tap of
// the other axis), and the atomics are not staged in shared memory.
//
// Build: as roi_align.cu (nvcc -gencode arch=compute_90a,code=sm_90a -O3
// -fmad=false ...), so the shared coordinate code rounds as the forward's;
// the sums use explicit __fmaf_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_geometry.cuh"

namespace {

using roi_align::kFull;
using roi_align::kMaxLevels;
using roi_align::kMaxRatio;
using roi_align::Pyramid;

constexpr int kMaxWarps = 16;

struct Params {
  const float* rois;
  const void* grad_out;        // (n, out_h, out_w, C) in the features' dtype
  float* grad_feat;            // float32 scratch, or null
  float* grad_rois;            // (gridDim.y, n, 4) partial sums, or null
  long long grad_offset[kMaxLevels];   // each level's (B, H, W, C) in grad_feat
  int n, batch, channels, out_h, out_w, max_ratio;
  float finest_scale, span_limit;
};

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
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  // element 2i is the low half of word i; a bfloat16 is the high half of
  // its float32
  __device__ static void load(const char* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// A list entry: a distinct tap (row or column index) and its merged weight.
struct Entry {
  int tap;
  float weight;
};

// A sample of a list: its near and far tap, coef = d(far weight)/dc =
// -d(near weight)/dc (0 when the sample is dead, outside [-1, size],
// clamped, or its two taps coincide), and a = dc/d(end) = 1 - dc/d(start).
struct Sample {
  int t0, t1;
  float coef, a;
};

// one block of kMaxWarps per SM at least: without the bound ptxas keeps
// the float32 build at 64 registers and spills
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
roi_align_backward_kernel(const Pyramid pyr, const Params p) {
  constexpr int V = Vec<T>::kWidth;
  extern __shared__ int4 smem[];
  const long long r = blockIdx.x;
  const roi_align::RoIGeometry geo = roi_align::roi_geometry(
      p.rois + 5 * r, pyr, p.batch, p.out_h, p.out_w, p.max_ratio, p.finest_scale,
      p.span_limit);
  const int lvl = geo.lvl;

  const int L = 2 * p.max_ratio;                  // entries per list
  const int n_lists = p.out_h + p.out_w;
  Entry* lists = reinterpret_cast<Entry*>(smem);
  Sample* samples = reinterpret_cast<Sample*>(lists + n_lists * L);
  int* counts = reinterpret_cast<int*>(samples + n_lists * p.max_ratio);
  float* red = reinterpret_cast<float*>(counts + n_lists);

  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1-2. the forward's lists (tap indices here), and every sample's taps
  //      and coordinate derivative
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
        if (t.live) {
          float coef = 0.f;
          if (t.valid && t.t1 != t.t0) {
            const float cm = fmaxf(t.c, 0.f), top = (float)size - 1.f;
            coef = (t.c > 0.f ? 1.f : t.c == 0.f ? 0.5f : 0.f) *
                   (cm < top ? 1.f : cm == top ? 0.5f : 0.f);
          }
          const float a =
              ((float)idx + ((float)i + 0.5f) / (float)g) / (float)(is_x ? p.out_w : p.out_h);
          samples[q * p.max_ratio + i] = Sample{t.t0, t.t1, coef, a};
        }
      }
    }
  }
  __syncthreads();

  // 3. the bins
  const int bins = p.out_h * p.out_w;
  const int nvec = p.channels / V;
  const int C = p.channels;
  const char* img = static_cast<const char*>(pyr.ptr[lvl]) +
                    (long long)geo.b * pyr.batch_stride[lvl] * (long long)sizeof(T);
  const long long rstride = pyr.row_stride[lvl] * (long long)sizeof(T);
  const long long cstride = pyr.col_stride[lvl] * (long long)sizeof(T);
  // the level's offset picked with constant indices: a kernel parameter
  // array indexed at run time would be copied to local memory
  long long level_offset = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) level_offset = l == lvl ? p.grad_offset[l] : level_offset;
  float* gimg = p.grad_feat == nullptr
                    ? nullptr
                    : p.grad_feat + level_offset + (long long)geo.b * geo.H * geo.W * C;
  const char* gout = static_cast<const char*>(p.grad_out) + r * bins * C * (long long)sizeof(T);
  float acc_x1 = 0.f, acc_y1 = 0.f, acc_x2 = 0.f, acc_y2 = 0.f;

  for (int bin_id = blockIdx.y * warps + warp; bin_id < bins; bin_id += gridDim.y * warps) {
    const int ph = bin_id / p.out_w, pw = bin_id % p.out_w;
    const Entry* ys = lists + ph * L;
    const Entry* xs = lists + (p.out_h + pw) * L;
    const int ny = counts[ph], nx = counts[p.out_h + pw];
    const Sample* sy = samples + ph * p.max_ratio;
    const Sample* sx = samples + (p.out_h + pw) * p.max_ratio;
    for (int cv = lane; cv < nvec; cv += 32) {
      float g[V];
      Vec<T>::load(gout + ((long long)bin_id * C + cv * V) * (long long)sizeof(T), g);

      if (gimg != nullptr) {
        // d level: one vector atomic per 4 channels for each distinct tap
        for (int a = 0; a < ny; ++a) {
          const Entry y = ys[a];
          float* grow = gimg + (long long)y.tap * geo.W * C + cv * V;
          for (int c = 0; c < nx; ++c) {
            const Entry x = xs[c];
            const float w = y.weight * x.weight;
            float* dst = grow + (long long)x.tap * C;
#pragma unroll
            for (int k = 0; k < V; k += 4) {
              atomicAdd(reinterpret_cast<float4*>(dst + k),
                        make_float4(w * g[k], w * g[k + 1], w * g[k + 2], w * g[k + 3]));
            }
          }
        }
      }

      if (p.grad_rois != nullptr) {
        const char* chan = img + cv * 16;
        // along y: each sample of the bin's row against its merged columns
        for (int k = 0; k < geo.gh; ++k) {
          const Sample s = sy[k];
          if (s.coef == 0.f) continue;
          float d = 0.f;
          for (int c = 0; c < nx; ++c) {
            const Entry x = xs[c];
            const char* col = chan + x.tap * cstride;
            float f0[V], f1[V];
            Vec<T>::load(col + s.t0 * rstride, f0);
            Vec<T>::load(col + s.t1 * rstride, f1);
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) dot = __fmaf_rn(g[e], f1[e] - f0[e], dot);
            d = __fmaf_rn(x.weight, dot, d);
          }
          d = d * (s.coef * geo.avg);
          acc_y1 += d * (1.f - s.a);
          acc_y2 += d * s.a;
        }
        // along x: each sample of the bin's column against its merged rows
        // (whose weights hold the average)
        for (int k = 0; k < geo.gw; ++k) {
          const Sample s = sx[k];
          if (s.coef == 0.f) continue;
          float d = 0.f;
          for (int a = 0; a < ny; ++a) {
            const Entry y = ys[a];
            const char* row = chan + y.tap * rstride;
            float f0[V], f1[V];
            Vec<T>::load(row + s.t0 * cstride, f0);
            Vec<T>::load(row + s.t1 * cstride, f1);
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) dot = __fmaf_rn(g[e], f1[e] - f0[e], dot);
            d = __fmaf_rn(y.weight, dot, d);
          }
          d = d * s.coef;
          acc_x1 += d * (1.f - s.a);
          acc_x2 += d * s.a;
        }
      }
    }
  }

  if (p.grad_rois != nullptr) {
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
    __syncthreads();
    if (threadIdx.x < 4) {
      float sum = 0.f;
      for (int w = 0; w < warps; ++w) sum += red[w * 4 + threadIdx.x];
      p.grad_rois[((long long)blockIdx.y * p.n + r) * 4 + threadIdx.x] = sum * geo.s;
    }
  }
}

// The launch: the forward's warps per block, and bins dealt over
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
             (2 * max_ratio * sizeof(Entry) + max_ratio * sizeof(Sample) + sizeof(int)) +
         4 * warps * sizeof(float);
}

}  // namespace

// The launch shape of a call: threads per block / 32 and blocks per RoI
// along blockIdx.y (the first dimension of grad_rois). 0 on success.
extern "C" int roi_align_backward_shape(int n, int out_h, int out_w, int* warps, int* split) {
  if (n <= 0 || out_h < 1 || out_w < 1) return (int)cudaErrorInvalidValue;
  launch_shape(n, out_h, out_w, warps, split);
  return 0;
}

// level_dims, inv_strides, rois, n, batch, channels, out_h, out_w,
// max_ratio, finest_scale and span_limit as roi_align_forward's;
// grad_offsets[l] is level l's offset, in floats, in grad_feat, which holds
// it contiguous (B, H_l, W_l, C) and must be zero on entry; grad_out is
// (n, out_h, out_w, C) contiguous in the levels' dtype. grad_feat or
// grad_rois may be null to skip that output; grad_rois receives (split, n,
// 4) partial sums, split from roi_align_backward_shape. Launches on
// `stream`, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int roi_align_backward(int is_bf16, int levels, const void* const* level_ptrs,
                                  const long long* level_dims, const float* inv_strides,
                                  const long long* grad_offsets, const void* rois,
                                  const void* grad_out, float* grad_feat, float* grad_rois,
                                  int n, int batch, int channels, int out_h, int out_w,
                                  int max_ratio, float finest_scale, float span_limit,
                                  void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0 || max_ratio < 1 || max_ratio > kMaxRatio) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramid pyr{};
  Params p{};
  for (int l = 0; l < levels; ++l) {
    pyr.ptr[l] = level_ptrs[l];
    pyr.height[l] = (int)level_dims[5 * l + 0];
    pyr.width[l] = (int)level_dims[5 * l + 1];
    pyr.batch_stride[l] = level_dims[5 * l + 2];
    pyr.row_stride[l] = level_dims[5 * l + 3];
    pyr.col_stride[l] = level_dims[5 * l + 4];
    pyr.inv_stride[l] = inv_strides[l];
    p.grad_offset[l] = grad_offsets[l];
  }
  pyr.levels = levels;
  p.rois = static_cast<const float*>(rois);
  p.grad_out = grad_out;
  p.grad_feat = grad_feat;
  p.grad_rois = grad_rois;
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
  const size_t smem = smem_bytes(out_h, out_w, max_ratio, warps);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, (unsigned)split);
  const dim3 block(warps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_backward_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(pyr, p);
  } else {
    roi_align_backward_kernel<float><<<grid, block, smem, s>>>(pyr, p);
  }
  return (int)cudaGetLastError();
}

// Registers per thread and local memory per thread (spills and stack) of
// the backward kernel in one dtype, as the loaded build reports them.
extern "C" int roi_align_backward_attributes(int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      is_bf16 ? cudaFuncGetAttributes(&a, roi_align_backward_kernel<__nv_bfloat16>)
              : cudaFuncGetAttributes(&a, roi_align_backward_kernel<float>);
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* roi_align_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
