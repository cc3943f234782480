// Staged RoIAlign, one tier-sized tile per RoI, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   monorun_tpu/ops/roi_align_pallas.py:55 _kernel
// (reached through multilevel_roi_align_pallas), which copies each RoI's
// tile, sized by the (16-row x 32-column) tier its taps touch, from the
// dual-orientation flat pyramid into VMEM and applies the per-RoI
// interpolation matrices Y (oh, Th) and X (ow, Tw) as two small matmuls.
// Plain version: monorun_tpu_torch/ops/roi_align_tile.py:tile_call_plain.
//
// Bound on an H100: bytes. Each tile element is read once from device
// memory and used in about one FMA per output row, so the kernel does about
// one FMA per byte, far below the card's ratio of operations to bandwidth.
// Unlike the direct kernel (roi_align.cu), which reads only the taps, it
// moves whole tiles: about 16 x 32 cells x 512 bytes = 256 KB per RoI at
// the typical tier in bfloat16 with C = 256, several times the pyramid at
// proposal scale, mostly from L2.
//
// Design: one block per (RoI, channel slice). The slice is 32 bytes of
// each cell (16 bfloat16 or 8 float32 channels), the least that uses whole
// 32-byte sectors. The block copies the RoI's tier, nrb * 16 rows x 32
// columns at a time, into shared memory with cp.async (the counterpart of
// the TPU's one strided DMA per RoI), then each thread owns one output
// column j and channel c and accumulates, in float32 on CUDA cores,
// sum_r Y[i][r] sum_w X[j][w] tile[r][w][c] into shared memory. Only the
// tier is read: Y and X are exactly zero beyond it, so no unloaded shared
// memory is ever multiplied (the TPU zeroes its scratch for 0 * NaN).
// Each RoI lands in its output row and orientation directly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include "roi_align_staged.cuh"

namespace {

using namespace staged;

constexpr int kThreads = 128;

struct TileArgs {
  const int* buf_id;
  const int* r0;
  const int* c0;
  const int* nrb;
  const int* ncb;
  const int* trans;
  const void* Y;   // (n, oh, th)
  const void* X;   // (n, ow, tw)
  void* out;       // (n, oh, ow, C)
  int channels, cs, oh, ow, th, tw;
};

size_t tile_smem(int cs, int elt, const TileArgs& a) {
  return align16((size_t)a.th * kColBlk * cs * elt) + (size_t)a.ow * a.oh * cs * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_tile_kernel(Buffers bufs, TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = a.cs, oh = a.oh, ow = a.ow;
  T* s = reinterpret_cast<T*>(smem);
  float* acc = reinterpret_cast<float*>(smem + align16((size_t)a.th * kColBlk * cs * sizeof(T)));
  const long long n = blockIdx.x;
  const int cs0 = blockIdx.y * cs;
  const int b = a.buf_id[n], r0 = a.r0[n], c0 = a.c0[n];
  const int nrb = a.nrb[n], ncb = a.ncb[n];
  const T* buf = static_cast<const T*>(bufs.ptr[b]);
  const T* Y = static_cast<const T*>(a.Y) + n * oh * a.th;
  const T* X = static_cast<const T*>(a.X) + n * ow * a.tw;

  zero_shared(acc, ow * oh * cs);
  for (int cb = 0; cb < ncb; ++cb) {
    const int x0 = c0 + cb * kColBlk;
    stage_window(s, kColBlk, buf, bufs.cols[b], a.channels, r0, nrb * kRowBlk, x0, kColBlk,
                 cs0, cs);
    cp_async_wait_all();
    __syncthreads();
    for (int t = threadIdx.x; t < ow * cs; t += blockDim.x) {
      accumulate_rows(acc, s, r0, x0, kColBlk, cs, t % cs, t / cs, Y, a.th, r0, nrb, X, a.tw,
                      c0, x0, x0 + kColBlk, oh);
    }
    __syncthreads();
  }
  write_roi(static_cast<T*>(a.out), acc, n, a.trans[n], a.channels, cs0, cs, oh, ow);
}

}  // namespace

// Tile align of n RoIs. Buffers: pointers, rows and columns of each level
// buffer. Per RoI (device int32 arrays): buffer, first row, first column
// (a multiple of 16), row blocks of 16, column blocks of 32, transposed.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// the cudaError_t of the launch (0 on success).
extern "C" int roi_align_tile_forward(int is_bf16, const void* const* buf_ptrs,
                                      const int* buf_rows, const int* buf_cols, int nbufs,
                                      const int* buf_id, const int* r0, const int* c0,
                                      const int* nrb, const int* ncb, const int* trans,
                                      const void* Y, const void* X, void* out, int n,
                                      int channels, int out_h, int out_w, int th, int tw,
                                      void* stream) {
  Buffers bufs{};
  int rc = make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (n <= 0 || th > 32 || th % kRowBlk || tw % kColBlk || out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  TileArgs a{buf_id, r0, c0, nrb, ncb, trans, Y, X, out, channels, 0, out_h, out_w, th, tw};
  const int elt = is_bf16 ? 2 : 4;
  a.cs = pick_slice(channels, elt, [&](int cs) { return tile_smem(cs, elt, a); });
  if (!a.cs) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)n, (unsigned)(channels / a.cs));
  const size_t smem = tile_smem(a.cs, elt, a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch(roi_align_tile_kernel<__nv_bfloat16>, grid, dim3(kThreads), smem, s,
                          bufs, a)
                 : launch(roi_align_tile_kernel<float>, grid, dim3(kThreads), smem, s, bufs, a);
}

extern "C" const char* roi_align_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
