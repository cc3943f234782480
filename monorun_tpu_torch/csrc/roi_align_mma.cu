// Staged RoIAlign with the row product on tensor cores, for Hopper
// (sm_90a): the K-packed and the whole-block band variants.
//
// Replaces the TPU Pallas kernels
//   monorun_tpu/ops/roi_align_band.py:330 _band_kernel_packed
//     (multilevel_roi_align_band(packed=True)): the row products of 4 RoIs
//     at once, as a block-diagonal Y4 (4 oh x 4 Th) against the 4 RoIs'
//     windows stacked along K (4 x 32 = 128 rows);
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
// many instructions the row product costs. The matmul variant also
// computes its row product for band rows outside a RoI's window, which
// costs operations, not bytes.
//
// Packed design: one block per (kroi-block, channel slice). For each chunk
// of 16 columns, the block stages each RoI's 32 window rows at its own
// column offset, stacked along K, into shared memory with cp.async,
// computes t1 = A @ B with mma.sync m16n8k16 (bfloat16 in, float32
// accumulate; N = 16 columns x the slice's channels), and then adds X @ t1
// for the chunk's columns into per-RoI sums in shared memory, in float32
// on CUDA cores. float32 features have no exact tensor-core mode (TF32
// keeps 10 bits), so their row product runs on CUDA cores in float32 with
// the same staging. The stack rows of a dummy slot are zero-filled, so no
// unloaded shared memory meets a zero weight (0 * NaN). Each RoI lands in
// its output row and orientation directly.
//
// Matmul design: the staged core of roi_align_ring.cuh, with A = the
// block's Y over the whole band (K = 64): a cp.async ring of column
// chunks, the row product on mma.sync with A in registers (bfloat16), t1
// and the per-RoI sums in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py).

#include <type_traits>

#include "roi_align_ring.cuh"

namespace {

using namespace staged;

constexpr int kThreads = 256;
constexpr int kBandRows = 64;
constexpr int kPack = 4;     // RoIs stacked along K (packed)
constexpr int kChunk = 16;   // columns per staged chunk: N = 16 x cs

template <typename T>
using IsBf16 = std::is_same<T, __nv_bfloat16>;

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// t1 (mpad x N, float32, shared) = A (mpad x K) @ B (K x N, bfloat16,
// shared, row stride N) on tensor cores, one warp per 16 x 8 output tile.
// load_a(m, k) returns A[m][k] and A[m][k + 1] packed (k even).
template <typename LoadA>
__device__ void product_mma(float* t1, const __nv_bfloat16* B, int K, int N, int mpad,
                            LoadA load_a, bool round_t1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = N / 8;
  for (int tile = warp; tile < (mpad / 16) * nt; tile += blockDim.x >> 5) {
    const int m0 = (tile / nt) * 16, n0 = (tile % nt) * 8;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + tig * 2;
      const __nv_bfloat16* bp = B + (long long)ka * N + n0 + gid;
      const uint32_t a[4] = {load_a(m0 + gid, ka), load_a(m0 + gid + 8, ka),
                             load_a(m0 + gid, ka + 8), load_a(m0 + gid + 8, ka + 8)};
      mma_bf16(d, a, pack_bf16(bp[0], bp[N]), pack_bf16(bp[8 * N], bp[9 * N]));
    }
    float* tp = t1 + (long long)(m0 + gid) * N + n0 + tig * 2;
    tp[0] = round_t1 ? round_bf16(d[0]) : d[0];
    tp[1] = round_t1 ? round_bf16(d[1]) : d[1];
    tp[8 * N] = round_t1 ? round_bf16(d[2]) : d[2];
    tp[8 * N + 1] = round_t1 ? round_bf16(d[3]) : d[3];
  }
}

// ---- K-packed (4 RoIs per row product) ------------------------------------

struct PackedArgs {
  const int* rw0;      // (m_pad,) window row
  const int* c0;       // (m_pad,) window column
  const int* ncb;      // (m_pad,) column tier
  const int* dst;      // (m_pad,) output row, -1 for dummies
  const int* trans;    // (m_pad,)
  const int* blk_buf;  // (nblk,)
  const void* Y;       // (m_pad, oh, th)
  const void* X;       // (m_pad, ow, tw)
  void* out;
  int kroi, channels, cs, oh, ow, th, tw;
};

struct PackedLayout {
  size_t t1, acc, y4, total;
};

__host__ __device__ inline PackedLayout packed_layout(int cs, int elt, int oh, int ow, int th) {
  const size_t K = kPack * th, N = (size_t)kChunk * cs, mpad = round16(kPack * oh);
  PackedLayout l;
  l.t1 = align16(K * N * elt);
  l.acc = l.t1 + align16(mpad * N * 4);
  l.y4 = l.acc + align16((size_t)kPack * ow * oh * cs * 4);
  l.total = l.y4 + mpad * K * 2;
  return l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_band_packed_kernel(Buffers bufs,
                                                                         PackedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = a.cs, oh = a.oh, ow = a.ow, th = a.th;
  const int K = kPack * th, N = kChunk * cs, mpad = round16(kPack * oh);
  const PackedLayout lay = packed_layout(cs, sizeof(T), oh, ow, th);
  T* ks = reinterpret_cast<T*>(smem);
  float* t1 = reinterpret_cast<float*>(smem + lay.t1);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  __nv_bfloat16* y4 = reinterpret_cast<__nv_bfloat16*>(smem + lay.y4);
  const int blk = blockIdx.x;
  const int cs0 = blockIdx.y * cs;
  const int b = a.blk_buf[blk];
  const T* buf = static_cast<const T*>(bufs.ptr[b]);
  const T* Y = static_cast<const T*>(a.Y);
  const T* X = static_cast<const T*>(a.X);

  for (int h = 0; h < a.kroi / kPack; ++h) {
    const long long first = (long long)blk * a.kroi + h * kPack;
    bool any = false;
    int tier = 1;
    for (int g = 0; g < kPack; ++g) {
      any |= a.dst[first + g] >= 0;
      tier = max(tier, a.ncb[first + g]);   // the group computes at its widest tier
    }
    if (!any) continue;
    zero_shared(acc, kPack * ow * oh * cs);
    if constexpr (IsBf16<T>::value) {
      // block-diagonal Y4: RoI g's (oh, th) block at rows g oh, columns g th
      for (int t = threadIdx.x; t < mpad * K; t += blockDim.x) {
        const int m = t / K, k = t % K, g = k / th;
        y4[t] = (m < kPack * oh && m / oh == g)
                    ? Y[((first + g) * oh + m % oh) * th + k % th]
                    : __float2bfloat16_rn(0.f);
      }
    }
    for (int k16 = 0; k16 < tier * (kColBlk / kChunk); ++k16) {
      for (int g = 0; g < kPack; ++g) {
        T* part = ks + (size_t)g * th * N;
        if (a.dst[first + g] >= 0) {
          stage_window(part, kChunk, buf, bufs.cols[b], a.channels, a.rw0[first + g], th,
                       a.c0[first + g] + k16 * kChunk, kChunk, cs0, cs);
        } else {
          for (int t = threadIdx.x; t < th * N; t += blockDim.x) store(part + t, 0.f);
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if constexpr (IsBf16<T>::value) {
        product_mma(t1, ks, K, N, mpad,
                    [&](int m, int k) { return *reinterpret_cast<const uint32_t*>(y4 + m * K + k); },
                    false);
      } else {
        for (int t = threadIdx.x; t < kPack * oh * N; t += blockDim.x) {
          const int m = t / N, n = t % N, g = m / oh;
          const float* yr = Y + ((first + g) * oh + m % oh) * th;
          const float* kc = ks + (size_t)g * th * N + n;
          float v = 0.f;
          for (int r = 0; r < th; ++r) v += yr[r] * kc[(size_t)r * N];
          t1[t] = v;
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < kPack * ow * oh * cs; t += blockDim.x) {
        const int c = t % cs, i = (t / cs) % oh, j = (t / (cs * oh)) % ow;
        const int g = t / (cs * oh * ow);
        const long long slot = first + g;
        if (a.dst[slot] < 0) continue;
        const T* xr = X + (slot * ow + j) * a.tw + k16 * kChunk;
        const float* tr = t1 + (size_t)(g * oh + i) * N + c;
        float v = 0.f;
        for (int w = 0; w < kChunk; ++w) v += to_float(xr[w]) * tr[w * cs];
        acc[t] += v;
      }
      __syncthreads();
    }
    for (int g = 0; g < kPack; ++g) {
      const int d = a.dst[first + g];
      if (d >= 0) {
        write_roi(static_cast<T*>(a.out), acc + (size_t)g * ow * oh * cs, d,
                  a.trans[first + g], a.channels, cs0, cs, oh, ow);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// K-packed band align over nblk blocks of kroi slots (kroi % 4 == 0). Per
// slot (device int32): window row and column, column tier, output row (-1
// for a dummy), transposed; per block: buffer. Launches on `stream`,
// allocates nothing, does not synchronise; returns the launch's
// cudaError_t.
extern "C" int roi_align_band_packed_forward(
    int is_bf16, const void* const* buf_ptrs, const int* buf_rows, const int* buf_cols,
    int nbufs, const int* rw0, const int* c0, const int* ncb, const int* dst, const int* trans,
    const int* blk_buf, const void* Y, const void* X, void* out, int nblk, int kroi,
    int channels, int out_h, int out_w, int th, int tw, void* stream) {
  Buffers bufs{};
  int rc = make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi % kPack || kroi < kPack || th > 32 || th % kRowBlk ||
      tw % kColBlk || out_h != out_w) {
    return (int)cudaErrorInvalidValue;
  }
  PackedArgs a{rw0, c0, ncb, dst, trans, blk_buf, Y, X, out,
               kroi, channels, 0, out_h, out_w, th, tw};
  const int elt = is_bf16 ? 2 : 4;
  a.cs = pick_slice(channels, elt,
                    [&](int cs) { return packed_layout(cs, elt, out_h, out_w, th).total; });
  if (!a.cs) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblk, (unsigned)(channels / a.cs));
  const size_t smem = packed_layout(a.cs, elt, out_h, out_w, th).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch(roi_align_band_packed_kernel<__nv_bfloat16>, grid, dim3(kThreads),
                          smem, s, bufs, a)
                 : launch(roi_align_band_packed_kernel<float>, grid, dim3(kThreads), smem, s,
                          bufs, a);
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
  Buffers bufs{};
  int rc = make_buffers(&bufs, buf_ptrs, buf_rows, buf_cols, nbufs);
  if (rc) return rc;
  if (nblk <= 0 || kroi < 1 || tw % kChunk || out_h != out_w) return (int)cudaErrorInvalidValue;
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
  return ring::launch<true>(is_bf16, bufs, a, nblk, static_cast<cudaStream_t>(stream));
}

// Registers, local memory bytes and static shared memory bytes of the
// loaded build's band-matmul kernel in each dtype.
extern "C" int roi_align_band_matmul_attributes(int is_bf16, int* regs, int* local,
                                                int* static_smem) {
  return ring::attributes<true>(is_bf16, regs, local, static_smem);
}

// The band-matmul launch shape of a call into v[0..8] (see ring::shape).
extern "C" int roi_align_band_matmul_shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  return ring::shape<true>(is_bf16, kroi, out_h, tw, v);
}

extern "C" const char* roi_align_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
