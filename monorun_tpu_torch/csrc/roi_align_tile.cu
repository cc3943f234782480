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
// Design: the staged core of roi_align_ring.cuh with one slot (RoI) per
// block. The slot's window is its tier, 16 x nrb rows by 32 x ncb columns
// at (r0, c0), so K is 16 or 32 and only the tier is read: Y and X are
// exactly zero beyond it. The tier's columns stream through the core's
// cp.async ring (the counterpart of the TPU's one strided copy per RoI),
// 4 stages of 32 rows of 512 bytes; the row product runs on
// tensor cores (bfloat16) with A = the RoI's Y in registers, one m-tile of
// 16 rows (7 or 14 used) and 64-channel slices; t1 and the sums stay in
// registers, and each RoI lands in its own output row and orientation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include "roi_align_ring.cuh"

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
  staged::Buffers bufs{};
  int rc = staged::make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (n <= 0 || th > 32 || th % staged::kRowBlk || tw % staged::kColBlk || out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  ring::Work a{};
  a.c0 = c0;
  a.rw0 = r0;
  a.nrb = nrb;
  a.ncb = ncb;
  a.trans = trans;
  a.blk_buf = buf_id;  // one slot per block
  a.Y = Y;
  a.X = X;
  a.out = out;
  a.kroi = 1;
  a.channels = channels;
  a.oh = out_h;
  a.ow = out_w;
  a.th = th;
  a.tw = tw;
  return ring::launch<ring::kTile>(is_bf16, bufs, a, n, static_cast<cudaStream_t>(stream));
}

// Registers, local memory bytes and static shared memory bytes of the
// loaded build's kernel in each dtype.
extern "C" int roi_align_tile_attributes(int is_bf16, int* regs, int* local, int* static_smem) {
  return ring::attributes<ring::kTile>(is_bf16, regs, local, static_smem);
}

// The launch shape of a call into v[0..8] (see ring::shape); kroi is 1.
extern "C" int roi_align_tile_shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  return ring::shape<ring::kTile>(is_bf16, kroi, out_h, tw, v);
}

extern "C" const char* roi_align_tile_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
