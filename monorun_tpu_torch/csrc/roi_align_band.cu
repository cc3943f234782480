// Staged RoIAlign over tier-uniform blocks of one 64-row band, for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel
//   monorun_tpu/ops/roi_align_band.py:142 _band_kernel_tiered
// (multilevel_roi_align_band(tiered=True), MONORUN_BAND_TIERED=1), which
// copies each touched 64-row band of the dual-orientation pyramid into VMEM
// once and serves every RoI of the band from it; RoIs are bucketed on the
// host by (buffer, band, column tier), so each block of kroi RoIs lies in
// one band and has one tier. Plain version:
// monorun_tpu_torch/ops/roi_align_band.py:band_call_plain.
//
// Bound on an H100: bytes, at about one FMA per byte read, as for every
// RoIAlign. Reading each band once bounds the traffic by about twice the
// pyramid, against tier-sized tiles per RoI for the tile kernel.
//
// Design: one block per (kroi-block, channel slice of 32 bytes per cell).
// The block's window is the union of its RoIs' windows: rows
// [min rw0, max rw0 + Th) (at most the 64 band rows) by columns
// [min c0, max c0 + 32 * tier). It stages that window once, 32 columns at
// a time, skipping chunks that no RoI of the block touches, with cp.async
// into shared memory, and every RoI of the block takes its rows and
// columns from the staged chunk: thread (RoI, output column j, channel c)
// accumulates sum_r Y[i][r] sum_w X[j][w] window[r][w][c] in float32 into
// shared memory. Dummy slots (padding, dst < 0) are skipped: they neither
// widen the window nor write. Each RoI lands in its output row and
// orientation directly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include <climits>

#include "roi_align_staged.cuh"

namespace {

using namespace staged;

constexpr int kThreads = 256;
constexpr int kBandRows = 64;

struct BandArgs {
  const int* rw0;      // (m_pad,) window row
  const int* c0;       // (m_pad,) window column
  const int* dst;      // (m_pad,) output row, -1 for dummies
  const int* trans;    // (m_pad,)
  const int* blk_buf;  // (nblk,)
  const int* blk_ncb;  // (nblk,) the block's column tier
  const void* Y;       // (m_pad, oh, th)
  const void* X;       // (m_pad, ow, tw)
  void* out;           // (n, oh, ow, C)
  int kroi, channels, cs, oh, ow, th, tw;
};

size_t band_smem(int cs, int elt, const BandArgs& a) {
  return align16((size_t)kBandRows * kColBlk * cs * elt) +
         (size_t)a.kroi * a.ow * a.oh * cs * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_band_tiered_kernel(Buffers bufs,
                                                                         BandArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = a.cs, oh = a.oh, ow = a.ow, kroi = a.kroi;
  T* s = reinterpret_cast<T*>(smem);
  float* acc =
      reinterpret_cast<float*>(smem + align16((size_t)kBandRows * kColBlk * cs * sizeof(T)));
  const int blk = blockIdx.x;
  const int cs0 = blockIdx.y * cs;
  const long long first = (long long)blk * kroi;
  const int b = a.blk_buf[blk];
  const int cols = a.blk_ncb[blk] * kColBlk;

  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
  for (int g = 0; g < kroi; ++g) {
    if (a.dst[first + g] < 0) continue;
    rmin = min(rmin, a.rw0[first + g]);
    rmax = max(rmax, a.rw0[first + g] + a.th);
    cmin = min(cmin, a.c0[first + g]);
    cmax = max(cmax, a.c0[first + g] + cols);
  }
  if (rmin == INT_MAX) return;  // an all-dummy block
  const T* buf = static_cast<const T*>(bufs.ptr[b]);
  const T* Y = static_cast<const T*>(a.Y);
  const T* X = static_cast<const T*>(a.X);

  zero_shared(acc, kroi * ow * oh * cs);
  for (int x0 = cmin; x0 < cmax; x0 += kColBlk) {
    const int x1 = min(x0 + kColBlk, cmax);
    bool used = false;
    for (int g = 0; g < kroi; ++g) {
      const int c0 = a.c0[first + g];
      used |= a.dst[first + g] >= 0 && c0 < x1 && c0 + cols > x0;
    }
    if (!used) continue;  // uniform across the block
    stage_window(s, kColBlk, buf, bufs.cols[b], a.channels, rmin, rmax - rmin, x0, x1 - x0,
                 cs0, cs);
    cp_async_wait_all();
    __syncthreads();
    for (int t = threadIdx.x; t < kroi * ow * cs; t += blockDim.x) {
      const int c = t % cs, j = (t / cs) % ow, g = t / (cs * ow);
      const long long slot = first + g;
      const int c0 = a.c0[slot];
      const int wlo = max(c0, x0), whi = min(c0 + cols, x1);
      if (a.dst[slot] < 0 || wlo >= whi) continue;
      accumulate_rows(acc + (size_t)g * ow * oh * cs, s, rmin, x0, kColBlk, cs, c, j,
                      Y + slot * oh * a.th, a.th, a.rw0[slot], a.th / kRowBlk,
                      X + slot * ow * a.tw, a.tw, c0, wlo, whi, oh);
    }
    __syncthreads();
  }
  for (int g = 0; g < kroi; ++g) {
    const int d = a.dst[first + g];
    if (d >= 0) {
      write_roi(static_cast<T*>(a.out), acc + (size_t)g * ow * oh * cs, d,
                a.trans[first + g], a.channels, cs0, cs, oh, ow);
    }
  }
}

}  // namespace

// Tiered band align over nblk blocks of kroi slots (m_pad = nblk * kroi).
// Per slot (device int32): window row and column, output row (-1 for a
// dummy), transposed; per block: buffer and column tier. Every real slot's
// window lies in its block's 64-row band. Launches on `stream`, allocates
// nothing, does not synchronise; returns the cudaError_t of the launch.
extern "C" int roi_align_band_tiered_forward(
    int is_bf16, const void* const* buf_ptrs, const int* buf_rows, const int* buf_cols,
    int nbufs, const int* rw0, const int* c0, const int* dst, const int* trans,
    const int* blk_buf, const int* blk_ncb, const void* Y, const void* X, void* out, int nblk,
    int kroi, int channels, int out_h, int out_w, int th, int tw, void* stream) {
  Buffers bufs{};
  int rc = make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi < 1 || th > 32 || th % kRowBlk || tw % kColBlk || out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  BandArgs a{rw0, c0, dst, trans, blk_buf, blk_ncb, Y, X, out,
             kroi, channels, 0, out_h, out_w, th, tw};
  const int elt = is_bf16 ? 2 : 4;
  a.cs = pick_slice(channels, elt, [&](int cs) { return band_smem(cs, elt, a); });
  if (!a.cs) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblk, (unsigned)(channels / a.cs));
  const size_t smem = band_smem(a.cs, elt, a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch(roi_align_band_tiered_kernel<__nv_bfloat16>, grid, dim3(kThreads),
                          smem, s, bufs, a)
                 : launch(roi_align_band_tiered_kernel<float>, grid, dim3(kThreads), smem, s,
                          bufs, a);
}

extern "C" const char* roi_align_band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
