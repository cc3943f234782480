// The per-RoI geometry of the direct RoIAlign kernels (forward
// roi_align.cu, backward roi_align_bwd.cu): level choice, scaled and
// shifted coordinates, sample grid, and the merged per-row and per-column
// tap lists, so that both kernels round every coordinate and weight the
// same way. Both sources are built with -fmad=false, which keeps each
// operation here rounding like the plain version's separate tensor
// operations (monorun_tpu_torch/ops/roi_align.py:sample_taps and
// merged_bin_taps).

#pragma once

#include <cuda_runtime.h>

namespace roi_align {

constexpr int kMaxLevels = 5;
constexpr int kMaxRatio = 16;    // samples per axis: one lane each, half a warp
constexpr unsigned kFull = 0xffffffffu;

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

// mmdet level mapping plus the long-side cap
// (monorun_tpu_torch/ops/roi_align.py:assign_fpn_levels)
__device__ __forceinline__ int roi_level(float w, float h, float finest_scale,
                                         float span_limit, int levels) {
  float lvl = floorf(log2f(sqrtf(w * h) / finest_scale + 1e-6f));
  if (span_limit > 0.f) {
    const float need =
        ceilf(log2f(fmaxf(fmaxf(w, h) / span_limit, 9.5367431640625e-07f)));  // 2^-20
    lvl = fmaxf(lvl, need);
  }
  return (int)fminf(fmaxf(lvl, 0.f), (float)(levels - 1));
}

// One RoI (batch, x1, y1, x2, y2 in image pixels) at its level: scaled by
// the level's 1/stride and shifted by -0.5, its bins and sample grid.
struct RoIGeometry {
  int b, lvl, gw, gh, H, W;
  float s, x1, y1, bin_w, bin_h, avg;
};

__device__ __forceinline__ RoIGeometry roi_geometry(const float* roi, const Pyramid& pyr,
                                                    int batch, int out_h, int out_w,
                                                    int max_ratio, float finest_scale,
                                                    float span_limit) {
  RoIGeometry g;
  // batch index clamped into range so a malformed RoI cannot read out of
  // bounds (the detector always passes valid indices)
  g.b = min(max((int)roi[0], 0), batch - 1);
  const float w = fmaxf(roi[3] - roi[1], 0.f);
  const float h = fmaxf(roi[4] - roi[2], 0.f);
  g.lvl = roi_level(w, h, finest_scale, span_limit, pyr.levels);
  g.s = pyr.inv_stride[g.lvl];
  g.x1 = roi[1] * g.s - 0.5f;
  g.y1 = roi[2] * g.s - 0.5f;
  const float roi_w = (roi[3] * g.s - 0.5f) - g.x1;
  const float roi_h = (roi[4] * g.s - 0.5f) - g.y1;
  g.bin_w = roi_w / (float)out_w;
  g.bin_h = roi_h / (float)out_h;
  g.gw = (int)fminf(fmaxf(ceilf(roi_w / (float)out_w), 1.f), (float)max_ratio);
  g.gh = (int)fminf(fmaxf(ceilf(roi_h / (float)out_h), 1.f), (float)max_ratio);
  g.avg = 1.f / (float)(g.gh * g.gw);
  g.H = pyr.height[g.lvl];
  g.W = pyr.width[g.lvl];
  return g;
}

// Sample i of one list (output row or column idx along one axis) and its
// two taps, merged with every tap of the list on the same row or column.
struct ListTaps {
  float c;            // the sample coordinate, before the clamp
  bool live, valid;   // i < g; and c in [-1, size]
  int t0, t1;         // near and far tap
  float s0, s1;       // merged weights of the taps this lane owns (times scale)
  bool own0, own1;    // whether this lane's near / far tap holds its merged weight
  int slot0, slot1;   // their places in the compacted list
  int count;          // entries in the list
};

// Every lane of the warp calls this together: lane i of each half (i =
// lane & 15) computes sample i of its half's list, with exactly the plain
// version's arithmetic, and merges its two taps with every tap of the list
// in tap order (near, far of sample 0, near, far of sample 1, ...): the
// first tap on a row/column holds the sum of their weights, the others drop
// out, and so do taps whose sum is zero (samples outside [-1, size], an
// exact integer coordinate); the far tap clamped onto the near one merges
// into it. The survivors are compacted by ballot: near taps, then far taps.
// g is 0 for a half without a list; gmax is the most g over the warp.
__device__ __forceinline__ ListTaps list_taps(float start, int idx, float bin, int g, int size,
                                              int gmax, float scale, int lane) {
  ListTaps t;
  const int half_base = lane & 16, i = lane & 15;
  const float sizef = (float)size;
  t.c = start + (float)idx * bin + ((float)i + 0.5f) * bin / (float)g;
  t.live = i < g;
  t.valid = t.live && t.c >= -1.f && t.c <= sizef;
  const float cc = fminf(fmaxf(t.c, 0.f), sizef - 1.f);
  const float cf = floorf(cc);
  t.t0 = (int)cf;
  t.t1 = min(t.t0 + 1, size - 1);
  const float lo = cc - cf;
  const float w0 = t.valid ? 1.f - lo : 0.f, w1 = t.valid ? lo : 0.f;

  float s0 = 0.f, s1 = 0.f;
  bool own0 = t.live, own1 = t.live && t.t1 != t.t0;
  for (int j = 0; j < gmax; ++j) {
    const int a0 = __shfl_sync(kFull, t.t0, half_base + j);
    const int a1 = __shfl_sync(kFull, t.t1, half_base + j);
    const float b0 = __shfl_sync(kFull, w0, half_base + j);
    const float b1 = __shfl_sync(kFull, w1, half_base + j);
    if (j < g) {
      s0 += a0 == t.t0 ? b0 : 0.f;
      s0 += a1 == t.t0 ? b1 : 0.f;
      s1 += a0 == t.t1 ? b0 : 0.f;
      s1 += a1 == t.t1 ? b1 : 0.f;
      if (j < i) {
        own0 = own0 && a0 != t.t0 && a1 != t.t0;
        own1 = own1 && a0 != t.t1 && a1 != t.t1;
      }
    }
  }
  t.own0 = own0 && s0 != 0.f;
  t.own1 = own1 && s1 != 0.f;
  t.s0 = s0 * scale;
  t.s1 = s1 * scale;
  const unsigned m0 = (__ballot_sync(kFull, t.own0) >> half_base) & 0xffffu;
  const unsigned m1 = (__ballot_sync(kFull, t.own1) >> half_base) & 0xffffu;
  const unsigned below = (1u << i) - 1u;
  t.slot0 = __popc(m0 & below);
  t.slot1 = __popc(m0) + __popc(m1 & below);
  t.count = __popc(m0) + __popc(m1);
  return t;
}

// Warps per block of both kernels: a multiple of 4 (each of the SM's four
// schedulers holds the same share of a block), at least half the list
// count (one list per half warp, so one pass builds them all), at most
// max_warps.
inline int block_warps(int out_h, int out_w, int max_warps) {
  const int lists4 = (out_h + out_w + 7) / 8 * 4;
  return lists4 < max_warps ? lists4 : max_warps;
}

}  // namespace roi_align
