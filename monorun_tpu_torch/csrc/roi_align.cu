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
// Bound on an H100: bytes. Each sample reads 4 taps of C channels and does
// 4 FMAs per channel on them, so the kernel does about one FMA per byte it
// loads: far below the card's ratio of operations to memory bandwidth. The
// least traffic is the distinct feature rows the taps touch plus the
// output, and the taps of neighbouring samples and RoIs overlap heavily, so
// most loads should hit L2 (50 MB, larger than one image's pyramid).
//
// Design: one block per RoI (split over blockIdx.y into groups of bins
// when there are too few RoIs to fill the SMs), one warp per output bin,
// and the 32 lanes of the warp across the channels, each lane owning a
// 16-byte vector (8 bf16 or 4 fp32 channels). The 4 taps of a sample are
// then fully coalesced 16-byte loads of contiguous NHWC rows, and each
// output bin is one coalesced 16-byte store per lane. The per-RoI geometry
// (level, grid size, scaled box) is a few scalar operations that every
// thread recomputes instead of synchronising through shared memory. The
// TPU staging (flat padded pyramid, tile DMAs, band bucketing, sorting by
// buffer) has no counterpart: a warp reads exactly the taps it needs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -shared -Xcompiler -fPIC (monorun_tpu_torch/ops/roi_align_cuda.py);
// -fmad=false keeps the coordinate and weight arithmetic rounding like the
// plain version's separate tensor operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kWarpsPerBlock = 8;

struct Pyramid {
  const void* ptr[kMaxLevels];
  long long batch_stride[kMaxLevels];
  long long row_stride[kMaxLevels];
  long long col_stride[kMaxLevels];
  int height[kMaxLevels];
  int width[kMaxLevels];
  float inv_stride[kMaxLevels];
  int levels;
};

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
  __device__ static void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// mmdet level mapping plus the long-side cap
// (monorun_tpu_torch/ops/roi_align.py:assign_fpn_levels)
__device__ __forceinline__ int roi_level(float w, float h, const Params& p, int levels) {
  float lvl = floorf(log2f(sqrtf(w * h) / p.finest_scale + 1e-6f));
  if (p.span_limit > 0.f) {
    const float need =
        ceilf(log2f(fmaxf(fmaxf(w, h) / p.span_limit, 9.5367431640625e-07f)));  // 2^-20
    lvl = fmaxf(lvl, need);
  }
  return (int)fminf(fmaxf(lvl, 0.f), (float)(levels - 1));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
roi_align_forward_kernel(const Pyramid pyr, const Params p) {
  constexpr int V = Pack<T>::kWidth;
  const long long r = blockIdx.x;
  const float* roi = p.rois + 5 * r;
  // batch index clamped into range so a malformed RoI cannot read out of
  // bounds (the detector always passes valid indices)
  const int b = min(max((int)roi[0], 0), p.batch - 1);
  const float w = fmaxf(roi[3] - roi[1], 0.f);
  const float h = fmaxf(roi[4] - roi[2], 0.f);
  const int lvl = roi_level(w, h, p, pyr.levels);

  const float s = pyr.inv_stride[lvl];
  const float x1 = roi[1] * s - 0.5f;
  const float y1 = roi[2] * s - 0.5f;
  const float roi_w = (roi[3] * s - 0.5f) - x1;
  const float roi_h = (roi[4] * s - 0.5f) - y1;
  const float bin_w = roi_w / (float)p.out_w;
  const float bin_h = roi_h / (float)p.out_h;
  const int gw = (int)fminf(fmaxf(ceilf(roi_w / (float)p.out_w), 1.f), (float)p.max_ratio);
  const int gh = (int)fminf(fmaxf(ceilf(roi_h / (float)p.out_h), 1.f), (float)p.max_ratio);
  const float gwf = (float)gw, ghf = (float)gh;
  const float avg = 1.f / (float)(gh * gw);

  const int H = pyr.height[lvl], W = pyr.width[lvl];
  const float Hf = (float)H, Wf = (float)W;
  const T* base = static_cast<const T*>(pyr.ptr[lvl]) + b * pyr.batch_stride[lvl];
  const long long rs = pyr.row_stride[lvl], cs = pyr.col_stride[lvl];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bins = p.out_h * p.out_w;
  const int nvec = p.channels / V;
  T* out = static_cast<T*>(p.out) + r * bins * p.channels;

  for (int bin = blockIdx.y * kWarpsPerBlock + warp; bin < bins;
       bin += gridDim.y * kWarpsPerBlock) {
    const int ph = bin / p.out_w, pw = bin - ph * p.out_w;
    for (int cv = lane; cv < nvec; cv += 32) {
      const int c0 = cv * V;
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      for (int iy = 0; iy < gh; ++iy) {
        const float y = y1 + (float)ph * bin_h + ((float)iy + 0.5f) * bin_h / ghf;
        const bool vy = y >= -1.f && y <= Hf;
        const float yc = fminf(fmaxf(y, 0.f), Hf - 1.f);
        const float yf = floorf(yc);
        const int y0 = (int)yf;
        const int y1i = min(y0 + 1, H - 1);
        const float ly = yc - yf, hy = 1.f - ly;
        for (int ix = 0; ix < gw; ++ix) {
          const float x = x1 + (float)pw * bin_w + ((float)ix + 0.5f) * bin_w / gwf;
          if (!(vy && x >= -1.f && x <= Wf)) continue;  // zero weight
          const float xc = fminf(fmaxf(x, 0.f), Wf - 1.f);
          const float xf = floorf(xc);
          const int x0 = (int)xf;
          const int x1i = min(x0 + 1, W - 1);
          const float lx = xc - xf, hx = 1.f - lx;
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
          float v00[V], v01[V], v10[V], v11[V];
          Pack<T>::load(base + y0 * rs + x0 * cs + c0, v00);
          Pack<T>::load(base + y0 * rs + x1i * cs + c0, v01);
          Pack<T>::load(base + y1i * rs + x0 * cs + c0, v10);
          Pack<T>::load(base + y1i * rs + x1i * cs + c0, v11);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            acc[k] += (((v00[k] * w00 + v01[k] * w01) + v10[k] * w10) + v11[k] * w11) * avg;
          }
        }
      }
      Pack<T>::store(out + (long long)bin * p.channels + c0, acc);
    }
  }
}

}  // namespace

// level_dims holds, per level: height, width, batch, row and column strides
// (in elements). span_limit <= 0 disables the long-side cap. Launches on
// `stream`, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int roi_align_forward(int is_bf16, int levels, const void* const* level_ptrs,
                                 const long long* level_dims, const float* inv_strides,
                                 const void* rois, void* out, int n, int batch, int channels,
                                 int out_h, int out_w, int max_ratio, float finest_scale,
                                 float span_limit, void* stream) {
  if (levels < 1 || levels > kMaxLevels || n <= 0 || max_ratio < 1) {
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

  // enough blocks to fill every SM a few times over: with few RoIs, split
  // each RoI's bins over blockIdx.y
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int bins = out_h * out_w;
  const int max_split = (bins + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int want = sms * 8;
  int split = n >= want ? 1 : (want + n - 1) / n;
  split = split < max_split ? split : max_split;

  const dim3 grid((unsigned)n, (unsigned)split);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_forward_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(pyr, p);
  } else {
    roi_align_forward_kernel<float><<<grid, block, 0, s>>>(pyr, p);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* roi_align_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
