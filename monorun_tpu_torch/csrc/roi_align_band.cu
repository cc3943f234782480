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
// Design: the staged core of roi_align_ring.cuh. A slot's window is rows
// [rw0, rw0 + th) by columns [c0, c0 + 32 x tier). The block's A stacks its
// slots' (oh x th) Y matrices zero-extended over the union of their rows
// (at most the 64 band rows, rounded up to 16), so one row product on
// tensor cores (bfloat16) serves every slot of the block; the union's
// columns stream through the core's cp.async ring, and each RoI's sums stay
// in registers until they land in its output row and orientation.
// ops/roi_align_band.py:union_product states the zero-extended product in
// plain PyTorch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include "roi_align_ring.cuh"

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
  staged::Buffers bufs{};
  int rc = staged::make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi < 1 || th > 32 || th % staged::kRowBlk || tw % staged::kColBlk ||
      out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  ring::Work a{};
  a.c0 = c0;
  a.rw0 = rw0;
  a.dst = dst;
  a.trans = trans;
  a.blk_buf = blk_buf;
  a.blk_ncb = blk_ncb;
  a.Y = Y;
  a.X = X;
  a.out = out;
  a.kroi = kroi;
  a.channels = channels;
  a.oh = out_h;
  a.ow = out_w;
  a.th = th;
  a.tw = tw;
  return ring::launch<ring::kBlockTier>(is_bf16, bufs, a, nblk,
                                       static_cast<cudaStream_t>(stream));
}

// Registers, local memory bytes and static shared memory bytes of the
// loaded build's kernel in each dtype.
extern "C" int roi_align_band_tiered_attributes(int is_bf16, int* regs, int* local,
                                                int* static_smem) {
  return ring::attributes<ring::kBlockTier>(is_bf16, regs, local, static_smem);
}

// The launch shape of a call into v[0..8] (see ring::shape).
extern "C" int roi_align_band_tiered_shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  return ring::shape<ring::kBlockTier>(is_bf16, kroi, out_h, tw, v);
}

extern "C" const char* roi_align_band_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
