// Staged RoIAlign with the row product on tensor cores, for Hopper
// (sm_90a): the K-packed and the whole-block band variants.
//
// Replaces the TPU Pallas kernels
//   monorun_tpu/ops/roi_align_band.py:330 _band_kernel_packed
//     (multilevel_roi_align_band(packed=True)): the row products of 4 RoIs
//     at once, as a block-diagonal Y4 (4 oh x 4 Th) against the 4 RoIs'
//     windows stacked along K (4 x 32 = 128 rows), each group of 4 at its
//     widest column tier;
//   monorun_tpu/ops/roi_align_band.py:227 _band_kernel_matmul
//     (MONORUN_ALIGN_IMPL=bandmm, MONORUN_BAND_MATMUL=1): the row products
//     of a whole block of kroi RoIs of one (64-row band, 2 Tw column panel)
//     group as one (kroi oh x 64) @ panel product, with Y built over the
//     whole band, the row product t1 kept in float32 or rounded to
//     bfloat16 (MONORUN_BAND_T1_BF16=1).
// Plain version of both: monorun_tpu_torch/ops/roi_align_band.py:
// band_call_plain (roi_align_tile.py:staged_align_plain).
//
// Bound on an H100: bytes. The interpolation is about one FMA per byte
// read, so the tensor cores cannot be the limit; what they change is how
// many instructions the row product costs. Both variants also compute
// their row product for rows outside a RoI's window, which costs
// operations, not bytes.
//
// Both run the staged core of roi_align_ring.cuh: a cp.async ring of
// column chunks, the row product on mma.sync with A in registers
// (bfloat16), t1 and the per-RoI sums in registers.
//  * Packed: a block of kroi slots lies in one 64-row band (the host
//    buckets by band and orders each band by tier). A slot's window is its
//    th rows by its own 32 x ncb columns; the TPU's block-diagonal K-stack
//    of 4 RoIs is the core's A zero-extended over the union of the block's
//    rows (K <= 64), and each slot's own tier gives the TPU's sums at the
//    widest tier of its group, since X is exactly zero past a slot's tier.
//  * Matmul: A = the block's Y over the whole band (K = 64), windows of the
//    panel's width.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include "roi_align_ring.cuh"

namespace {

constexpr int kBandRows = 64;
constexpr int kPack = 4;       // RoIs stacked along K by the TPU kernel (packed)
constexpr int kPanelStep = 16; // matmul panels: tw in steps of 16 columns

}  // namespace

// K-packed band align over nblk blocks of kroi slots (kroi % 4 == 0). Per
// slot (device int32): window row and column, column tier, output row (-1
// for a dummy), transposed; per block: buffer. Every real slot's window
// lies in its block's 64-row band. Launches on `stream`, allocates
// nothing, does not synchronise; returns the launch's cudaError_t.
extern "C" int roi_align_band_packed_forward(
    int is_bf16, const void* const* buf_ptrs, const int* buf_rows, const int* buf_cols,
    int nbufs, const int* rw0, const int* c0, const int* ncb, const int* dst, const int* trans,
    const int* blk_buf, const void* Y, const void* X, void* out, int nblk, int kroi,
    int channels, int out_h, int out_w, int th, int tw, void* stream) {
  staged::Buffers bufs{};
  int rc = staged::make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi % kPack || kroi < kPack || th > 32 || th % staged::kRowBlk ||
      tw % staged::kColBlk || out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  ring::Work a{};
  a.c0 = c0;
  a.rw0 = rw0;
  a.ncb = ncb;
  a.dst = dst;
  a.trans = trans;
  a.blk_buf = blk_buf;
  a.Y = Y;
  a.X = X;
  a.out = out;
  a.kroi = kroi;
  a.channels = channels;
  a.oh = out_h;
  a.ow = out_w;
  a.th = th;
  a.tw = tw;
  return ring::launch<ring::kSlotTier>(is_bf16, bufs, a, nblk,
                                      static_cast<cudaStream_t>(stream));
}

// Registers, local memory bytes and static shared memory bytes of the
// loaded build's band-packed kernel in each dtype.
extern "C" int roi_align_band_packed_attributes(int is_bf16, int* regs, int* local,
                                                int* static_smem) {
  return ring::attributes<ring::kSlotTier>(is_bf16, regs, local, static_smem);
}

// The band-packed launch shape of a call into v[0..8] (see ring::shape).
extern "C" int roi_align_band_packed_shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  return ring::shape<ring::kSlotTier>(is_bf16, kroi, out_h, tw, v);
}

// Whole-block band align over nblk blocks of kroi slots, on the staged core
// of roi_align_ring.cuh. Per slot (device int32): window column inside the
// panel, output row (-1 for a dummy), transposed; per block: buffer, first
// band row, first panel column, active. Y spans the whole 64-row band.
// t1_bf16 rounds the row product (and X) to bfloat16. Launches on
// `stream`, allocates nothing, does not synchronise; returns the launch's
// cudaError_t.
extern "C" int roi_align_band_matmul_forward(
    int is_bf16, const void* const* buf_ptrs, const int* buf_rows, const int* buf_cols,
    int nbufs, const int* c0rel, const int* dst, const int* trans, const int* blk_buf,
    const int* blk_start, const int* blk_po, const int* blk_act, const void* Y, const void* X,
    void* out, int nblk, int kroi, int channels, int out_h, int out_w, int tw, int t1_bf16,
    void* stream) {
  staged::Buffers bufs{};
  int rc = staged::make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi < 1 || tw % kPanelStep || out_h != out_w) return (int)cudaErrorInvalidValue;
  ring::Work a{};
  a.c0 = c0rel;
  a.dst = dst;
  a.trans = trans;
  a.blk_buf = blk_buf;
  a.blk_start = blk_start;
  a.blk_po = blk_po;
  a.blk_act = blk_act;
  a.Y = Y;
  a.X = X;
  a.out = out;
  a.kroi = kroi;
  a.channels = channels;
  a.oh = out_h;
  a.ow = out_w;
  a.th = kBandRows;
  a.tw = tw;
  a.t1_bf16 = t1_bf16 != 0;
  return ring::launch<ring::kPanel>(is_bf16, bufs, a, nblk, static_cast<cudaStream_t>(stream));
}

// Registers, local memory bytes and static shared memory bytes of the
// loaded build's band-matmul kernel in each dtype.
extern "C" int roi_align_band_matmul_attributes(int is_bf16, int* regs, int* local,
                                                int* static_smem) {
  return ring::attributes<ring::kPanel>(is_bf16, regs, local, static_smem);
}

// The band-matmul launch shape of a call into v[0..8] (see ring::shape).
extern "C" int roi_align_band_matmul_shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  return ring::shape<ring::kPanel>(is_bf16, kroi, out_h, tw, v);
}

extern "C" const char* roi_align_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
