// The staged core of the RoIAlign kernels for Hopper (sm_90a): its four
// users, thin launchers of ring_align_kernel below, are
//   roi_align_band.cu      band tiered  (roi_align_band.py:142 _band_kernel_tiered)
//   roi_align_mma.cu       band packed  (roi_align_band.py:330 _band_kernel_packed)
//                          band matmul  (roi_align_band.py:227 _band_kernel_matmul)
//   roi_align_tile.cu      tile         (roi_align_pallas.py:55 _kernel)
//
// All compute, for each slot (RoI) of a block of kroi slots,
//   out[i][j][c] = sum_w X[j][w] sum_r Y[i][r] window[r][w][c]
// as a row product t1 = A @ window over up to 64 buffer rows, then a column
// product with X. A slot's window is rows [rw0, rw0 + rows) by columns
// [c0, c0 + width) of the block's buffer:
//   matmul  the whole 64-row band by the 2 Tw panel (Y spans the band);
//   tiered  th rows by the block's column tier, 32 x tier columns;
//   packed  th rows by the slot's own tier, 32 x ncb columns;
//   tile    16 x nrb rows by 32 x ncb columns, one slot per block, which
//           writes output row = its slot (no dst array).
// A stacks the block's Y matrices, one row per (slot, output row), each
// zero-extended to the union of its slots' rows: exact zeros outside a
// slot's own rows. With K = the union rows rounded up to 16 (at most 64,
// the band; a tile's K is its own 16 x nrb rows), one product serves every
// slot. Each slot then takes only its own columns of t1, so a packed slot
// that is narrower than its neighbours gives the same sums as the TPU
// kernel, which computes each group of 4 at its widest tier: X is exactly
// zero past a slot's 32 x ncb columns.
//
// Bound on an H100: bytes, at about one FMA per byte read, as for every
// RoIAlign (the zero-extended rows cost tensor-core operations, not bytes).
//
// Design. A block covers one kroi-block, `mt` m-tiles of 16 A rows, `cs`
// channels (mt x cs / 8 = 8 warps) and kJB output columns j: 8 in
// bfloat16, where 16 columns of sums spill past the 128 registers of 2
// blocks per SM, so a 14x14 output takes two blocks, each repeating the
// row product on tensor cores; 16 in float32 when the output is wider
// than 8, so a 14x14 output computes its CUDA-core row product once. It
// streams the columns of the union of its slots' windows, skipping chunks
// that no slot uses, through a ring of 3 shared-memory stages (a tile: 4) of
// K rows x `ch` columns x cs channels, copied with cp.async and
// commit/wait groups: the copy of the next chunks overlaps the arithmetic
// on this one, behind one barrier per chunk. A stage holds 64 rows of 256
// bytes (a tile: 32 rows of 512 bytes, twice the columns per chunk and
// barrier), each padded by 16 so that ldmatrix rows fall into distinct
// banks. The window kind is a template parameter, so each kernel's row
// stride and slot lookups are constants. The channel slices of a block
// are neighbours in the grid, so they run together and read whole cells
// of the same window rows from L2. A warp owns one m-tile and one group
// of 8 channels for the whole sweep:
//  * bfloat16: its A fragments (16 rows x K) stay in registers; for each
//    column it loads the B fragments with ldmatrix.trans and issues
//    mma.sync m16n8k16 (bfloat16 in, float32 sums) into a fresh t1
//    fragment; float32 features (no exact tensor-core mode) compute the
//    same fragment on CUDA cores from A staged in shared memory;
//  * t1 never leaves registers: each lane multiplies its fragment (2 rows
//    x 2 channels) by its rows' X[j][w] (staged once per block, read as
//    16-byte vectors) and adds into kJB x 4 float32 sums in
//    registers, which it writes at the end straight to each RoI's output
//    row, in its orientation.
// Columns outside a row's window take no product (they hold zero X).
// t1_bf16 rounds t1 and X to bfloat16 before the column product, as the
// plain version does. Dummy slots (dst < 0) neither widen the union nor
// write; inactive blocks return at once. Slices of fewer than cs channels
// at the channel edge are zero-filled and not written. Every staged cell
// is either copied or zero-filled, so no unloaded shared memory meets a
// zero weight. ops/roi_align_band.py:union_product states the product in
// plain PyTorch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// (monorun_tpu_torch/ops/roi_align_cuda.py); the sums call __fmaf_rn.

#pragma once

#include <algorithm>
#include <climits>
#include <type_traits>

#include "roi_align_staged.cuh"

namespace ring {

using staged::Buffers;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;                 // band rows: the row product's largest K
constexpr int kBandRowData = 256;         // bytes of one staged row of 64
constexpr int kARow = kMaxK + 4;          // float32 A row stride (floats)

// How the kernel finds a slot's window (its kWin).
enum Window : int {
  kPanel,      // matmul: the 64-row band by the panel; Y spans the band
  kBlockTier,  // tiered: th rows by the block's tier
  kSlotTier,   // packed: th rows by the slot's own tier
  kTile,       // tile: 16 x nrb rows by 32 x ncb columns, one slot per block,
               // whose output row is the slot
};

// Rows of a ring stage: a tile's window has at most 32, a band block's 64.
__host__ __device__ constexpr int stage_rows(int win) { return win == kTile ? 32 : kMaxK; }
// Stages of the ring: a tile's are smaller, and its block has one RoI.
__host__ __device__ constexpr int ring_stages(int win) { return win == kTile ? 4 : 3; }
__host__ __device__ constexpr int row_data(int win) {
  return kBandRowData * kMaxK / stage_rows(win);
}

// Output columns per block (the kernel's kJB).
inline int columns_per_block(int elt, int ow) { return elt == 4 && ow > 8 ? 16 : 8; }

// The launch shape, chosen on the host from the call.
struct Shape {
  int mt;         // m-tiles (16 A rows) per block: 1, 2 or 4
  int jb;         // output columns per block
  int cs;         // channels per block: 8 x (8 / mt)
  int ch;         // columns per ring stage: row_data / (cs x element size)
  int vec_log2;   // log2 of the 16-byte vectors of a staged cell: cs x element size / 16
  int mgroups;    // blocks along A's rows per kroi-block
  int jgroups;    // blocks along the output columns
  int slots;      // most slots the rows of one block touch
  int info_off;   // shared memory: slot windows, X, float32 A
  int x_off;
  int a_off;
  int smem;
};

struct Work {
  const int* c0;         // (m_pad,) window column (matmul: inside the panel)
  const int* rw0;        // (m_pad,) window row (all but matmul)
  const int* nrb;        // (m_pad,) window rows in blocks of 16 (tile)
  const int* ncb;        // (m_pad,) window columns in blocks of 32 (packed, tile)
  const int* dst;        // (m_pad,) output row, -1 for dummies (not tile)
  const int* trans;      // (m_pad,)
  const int* blk_buf;    // (nblk,)
  const int* blk_start;  // (nblk,) first band row (matmul)
  const int* blk_po;     // (nblk,) first panel column (matmul)
  const int* blk_act;    // (nblk,) 0 for trailing all-dummy blocks (matmul)
  const int* blk_ncb;    // (nblk,) column tier (tiered)
  const void* Y;         // (m_pad, oh, th); a tile's (n, oh, th)
  const void* X;         // (m_pad, ow, tw)
  void* out;             // (n, oh, ow, C)
  int kroi, channels, oh, ow, th, tw, t1_bf16;
  Shape s;
};

inline Shape make_shape(int win, int elt, int kroi, int oh, int ow, int tw) {
  Shape s{};
  const int mtiles = (kroi * oh + 15) / 16;
  s.mt = mtiles >= 3 ? 4 : mtiles;
  s.cs = 8 * (kWarps / s.mt);
  s.ch = row_data(win) / (s.cs * elt);
  while (16 << s.vec_log2 < s.cs * elt) ++s.vec_log2;
  s.mgroups = (mtiles + s.mt - 1) / s.mt;
  s.jb = columns_per_block(elt, ow);
  s.jgroups = (ow + s.jb - 1) / s.jb;
  s.slots = kroi < (s.mt * 16 - 1) / oh + 2 ? kroi : (s.mt * 16 - 1) / oh + 2;
  s.info_off = ring_stages(win) * stage_rows(win) * (row_data(win) + 16);
  s.x_off = (int)staged::align16(s.info_off + 2 * s.slots * 4);
  s.a_off = (int)staged::align16(s.x_off + (size_t)s.slots * tw * s.jb * elt);
  s.smem = s.a_off + (elt == 4 ? s.mt * 16 * kARow * 4 : 0);
  return s;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bfloat16 matrices, transposed: lane l gives the address of row
// l (rows of 8 contiguous channels), r[q] holds matrix q's fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void to_floats(const uint4& u, float* f, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_floats(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int kWin, int kJB>
__global__ void __launch_bounds__(kThreads, 2) ring_align_kernel(Buffers bufs, Work a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool kMatmul = kWin == kPanel;
  constexpr int kVec = 16 / (int)sizeof(T);  // elements per 16-byte vector
  constexpr int kRows = stage_rows(kWin), kRowData = row_data(kWin);
  constexpr int kRowBytes = kRowData + 16, kStageBytes = kRows * kRowBytes;
  constexpr int kStages = ring_stages(kWin);
  const Shape& sh = a.s;
  // the channel slices of one block run side by side: together they read
  // whole cells of the staged windows
  const int nslices = (a.channels + sh.cs - 1) / sh.cs;
  const int bx = blockIdx.x / nslices, slice = blockIdx.x % nslices;
  const int per_blk = sh.mgroups * sh.jgroups;
  const int blk = bx / per_blk;
  const int mg = bx % per_blk / sh.jgroups;
  const int j0 = bx % sh.jgroups * kJB;
  if (kMatmul && !a.blk_act[blk]) return;
  const int oh = a.oh, ow = a.ow, tw = a.tw;
  const long long first = (long long)blk * a.kroi;
  const int m_lo = mg * sh.mt * 16;
  const int m_hi = min(a.kroi * oh, m_lo + sh.mt * 16);
  const int g_lo = m_lo / oh;
  const int nsl = (m_hi - 1) / oh + 1 - g_lo;
  const int b = a.blk_buf[blk];
  const int col_base = kMatmul ? a.blk_po[blk] : 0;

  // a slot's output row and window
  auto dst_of = [&](long long slot) -> long long {
    if constexpr (kWin == kTile) {
      return slot;
    } else {
      return a.dst[slot];
    }
  };
  auto rows_of = [&](long long slot) -> int {
    if constexpr (kWin == kTile) {
      return a.nrb[slot] * staged::kRowBlk;
    } else {
      return a.th;
    }
  };
  auto width_of = [&](long long slot) -> int {
    if constexpr (kWin == kPanel) {
      return tw;
    } else if constexpr (kWin == kBlockTier) {
      return a.blk_ncb[blk] * staged::kColBlk;
    } else {
      return a.ncb[slot] * staged::kColBlk;
    }
  };

  // the union of the real slots' windows (uniform across the block)
  int cmin = INT_MAX, cmax = INT_MIN, rmin = INT_MAX, rmax = INT_MIN, xw = 0;
  for (int g = 0; g < nsl; ++g) {
    const long long slot = first + g_lo + g;
    if (dst_of(slot) < 0) continue;
    const int lo = col_base + a.c0[slot];
    cmin = min(cmin, lo);
    cmax = max(cmax, lo + width_of(slot));
    xw = max(xw, width_of(slot));
    if (!kMatmul) {
      rmin = min(rmin, a.rw0[slot]);
      rmax = max(rmax, a.rw0[slot] + rows_of(slot));
    }
  }
  if (cmin == INT_MAX) return;  // no real slot in these rows
  int r0 = 0, K = kMaxK;
  if (kMatmul) {
    r0 = a.blk_start[blk];
  } else {
    // every window lies in the block's 64-row band (a tile: its own rows)
    K = min(kRows, (rmax - rmin + 15) / 16 * 16);
    r0 = max(0, min(rmin, bufs.rows[b] - K));
  }

  int* s_lo = reinterpret_cast<int*>(smem + sh.info_off);
  int* s_hi = s_lo + sh.slots;
  T* xs = reinterpret_cast<T*>(smem + sh.x_off);
  float* as = reinterpret_cast<float*>(smem + sh.a_off);
  for (int t = threadIdx.x; t < nsl; t += kThreads) {
    const long long slot = first + g_lo + t;
    const bool real = dst_of(slot) >= 0;
    s_lo[t] = real ? col_base + a.c0[slot] : INT_MAX;
    s_hi[t] = real ? col_base + a.c0[slot] + width_of(slot) : INT_MIN;
  }
  // X of the block's slots, [slot][w][j] for j in [j0, j0 + kJB), zero past
  // ow, for the columns w of the widest window
  const T* X = static_cast<const T*>(a.X);
  for (int t = threadIdx.x; t < nsl * xw * kJB; t += kThreads) {
    const int w = t % xw, jj = t / xw % kJB, g = t / (xw * kJB);
    float v = 0.f;
    if (j0 + jj < ow) v = staged::to_float(X[((first + g_lo + g) * ow + j0 + jj) * tw + w]);
    staged::store(xs + ((size_t)g * tw + w) * kJB + jj, a.t1_bf16 ? staged::round_bf16(v) : v);
  }

  // A[m][k]: the element of Y, or -1 where A is zero
  auto y_index = [&](int m, int k) -> long long {
    if (m >= m_hi) return -1;
    if (kMatmul) return (first * oh + m) * a.th + k;
    const long long slot = first + m / oh;
    const int kk = k - (a.rw0[slot] - r0);
    return (kk >= 0 && kk < rows_of(slot)) ? (first * oh + m) * a.th + kk : -1;
  };
  if constexpr (!kBf16) {
    const float* Yf = static_cast<const float*>(a.Y);
    for (int t = threadIdx.x; t < sh.mt * 16 * K; t += kThreads) {
      const int r = t / K, k = t % K;
      const long long i = y_index(m_lo + r, k);
      as[r * kARow + k] = i < 0 ? 0.f : Yf[i];
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mtw = warp % sh.mt, cg = warp / sh.mt;
  const int m0 = m_lo + mtw * 16;

  // this lane's two A rows: window, X rows; width 0 for no real slot
  int lo[2], wid[2], xoff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + gid + 8 * h;
    lo[h] = INT_MAX;
    wid[h] = 0;
    xoff[h] = 0;
    if (m < m_hi && dst_of(first + m / oh) >= 0) {
      lo[h] = col_base + a.c0[first + m / oh];
      wid[h] = width_of(first + m / oh);
      xoff[h] = (m / oh - g_lo) * tw * kJB;
    }
  }
  // float32: whether rows gid + 8 of the m-tile hold a slot (a tile at
  // 7x7 uses 7 rows of 16: its row product then skips the other half)
  const bool rows_hi = __any_sync(0xffffffffu, wid[1] != 0);
  const int wlo = __reduce_min_sync(0xffffffffu, min(lo[0], lo[1]));
  const int whi = __reduce_max_sync(
      0xffffffffu, max(wid[0] ? lo[0] + wid[0] : INT_MIN, wid[1] ? lo[1] + wid[1] : INT_MIN));

  uint32_t af[4][4];
  if constexpr (kBf16) {
    const unsigned short* Yb = static_cast<const unsigned short*>(a.Y);
    auto bits = [&](int m, int k) -> uint32_t {
      const long long i = y_index(m, k);
      return i < 0 ? 0u : (uint32_t)Yb[i];
    };
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = ks * 16 + 2 * tig;
      const bool in = ks * 16 < K;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + gid + (q & 1) * 8, kq = k + (q >> 1) * 8;
        af[ks][q] = in ? bits(m, kq) | (bits(m, kq + 1) << 16) : 0u;
      }
    }
  }

  float acc[kJB][4];
#pragma unroll
  for (int jj = 0; jj < kJB; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
  __syncthreads();

  const T* buf = static_cast<const T*>(bufs.ptr[b]);
  const int bcols = bufs.cols[b], brows = bufs.rows[b];
  const int C = a.channels, cs0 = slice * sh.cs;
  const int nq = (cmax - cmin + sh.ch - 1) / sh.ch;
  auto next_used = [&](int q) {
    for (; q < nq; ++q) {
      const int x0 = cmin + q * sh.ch, x1 = x0 + sh.ch;
      for (int g = 0; g < nsl; ++g) {
        if (s_lo[g] < x1 && s_hi[g] > x0) return q;
      }
    }
    return nq;
  };
  auto stage = [&](int q, int st) {
    unsigned char* base = smem + st * kStageBytes;
    const int x0 = cmin + q * sh.ch;
    for (int v = threadIdx.x; v < K * (kRowData / 16); v += kThreads) {
      const int r = v / (kRowData / 16), o = v % (kRowData / 16);
      // o = 16-byte vector (x - x0) * 2^vec_log2 + (c - cs0) / kVec of a staged row
      const int xo = o >> sh.vec_log2;
      const int x = x0 + xo, c = cs0 + (o - (xo << sh.vec_log2)) * kVec;
      unsigned char* d = base + r * kRowBytes + o * 16;
      if (x < bcols && c < C && r0 + r < brows) {
        staged::cp_async16(d, buf + ((long long)(r0 + r) * bcols + x) * C + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  int q_issue = next_used(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (q_issue < nq) {
      stage(q_issue, s);
      q_issue = next_used(q_issue + 1);
    }
    cp_async_commit();
  }
  int it = 0;
#pragma unroll 1
  for (int q = next_used(0); q < nq; q = next_used(q + 1), ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (q_issue < nq) {
      stage(q_issue, (it + kStages - 1) % kStages);
      q_issue = next_used(q_issue + 1);
    }
    cp_async_commit();

    const unsigned char* base = smem + (it % kStages) * kStageBytes;
    const int x0 = cmin + q * sh.ch;
    const int xa = max(x0, wlo), xb = min(x0 + sh.ch, whi);
#pragma unroll 1
    for (int x = xa; x < xb; ++x) {
      const int col = x - x0;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (kBf16) {
        const unsigned char* bp = base + lane * kRowBytes + (col * sh.cs + cg * 8) * 2;
        // two chains of at most two dependent mma (rows 0-31 and 32-63)
        float e[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t r[4], u[4];
        ldmatrix_x4_trans(r, bp);
        if (K > 32) ldmatrix_x4_trans(u, bp + 32 * kRowBytes);
        staged::mma_bf16(d, af[0], r[0], r[1]);
        if (K > 32) staged::mma_bf16(e, af[2], u[0], u[1]);
        if (K > 16) staged::mma_bf16(d, af[1], r[2], r[3]);
        if (K > 48) staged::mma_bf16(e, af[3], u[2], u[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) d[i] += e[i];
      } else {
        const float* a0 = as + (mtw * 16 + gid) * kARow;
        const float* a1 = a0 + 8 * kARow;
        const unsigned char* sp = base + (col * sh.cs + cg * 8 + 2 * tig) * 4;
        auto product = [&](auto both) {
#pragma unroll 1
          for (int k = 0; k < K; k += 4) {
            const float4 u0 = *reinterpret_cast<const float4*>(a0 + k);
            const float4 u1 = decltype(both)::value ? *reinterpret_cast<const float4*>(a1 + k)
                                                    : float4{};
            const float y0[4] = {u0.x, u0.y, u0.z, u0.w};
            const float y1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float2 s = *reinterpret_cast<const float2*>(sp + (k + kk) * kRowBytes);
              d[0] = __fmaf_rn(y0[kk], s.x, d[0]);
              d[1] = __fmaf_rn(y0[kk], s.y, d[1]);
              if constexpr (decltype(both)::value) {
                d[2] = __fmaf_rn(y1[kk], s.x, d[2]);
                d[3] = __fmaf_rn(y1[kk], s.y, d[3]);
              }
            }
          }
        };
        if (rows_hi) {
          product(std::true_type{});
        } else {
          product(std::false_type{});
        }
      }
      if (a.t1_bf16) {
#pragma unroll
        for (int r = 0; r < 4; ++r) d[r] = staged::round_bf16(d[r]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int w = x - lo[h];
        if (w < 0 || w >= wid[h]) continue;
        const uint4* xp = reinterpret_cast<const uint4*>(xs + xoff[h] + w * kJB);
#pragma unroll
        for (int v = 0; v < kJB / kVec; ++v) {
          float f[kVec];
          to_floats(xp[v], f, static_cast<const T*>(nullptr));
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            acc[v * kVec + e][2 * h] = __fmaf_rn(f[e], d[2 * h], acc[v * kVec + e][2 * h]);
            acc[v * kVec + e][2 * h + 1] =
                __fmaf_rn(f[e], d[2 * h + 1], acc[v * kVec + e][2 * h + 1]);
          }
        }
      }
    }
  }

  const int c = cs0 + cg * 8 + 2 * tig;
  if (c >= C) return;  // C is even: a pair is all in or all out
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!wid[h]) continue;
    const int m = m0 + gid + 8 * h;
    const long long slot = first + m / oh;
    const long long dst = dst_of(slot);
    const int tr = a.trans[slot], i = m % oh;
#pragma unroll
    for (int jj = 0; jj < kJB; ++jj) {
      const int j = j0 + jj;
      if (j >= ow) continue;
      const int p = tr ? j : i, qc = tr ? i : j;
      store_pair(out + ((dst * oh + p) * ow + qc) * C + c, acc[jj][2 * h], acc[jj][2 * h + 1]);
    }
  }
}

using KernelFn = void (*)(Buffers, Work);

// The build for a window kind, dtype and output columns per block
// (bfloat16 takes 8).
template <int kWin>
inline KernelFn kernel_for(int is_bf16, int jb) {
  if (is_bf16) return &ring_align_kernel<__nv_bfloat16, kWin, 8>;
  return jb == 16 ? &ring_align_kernel<float, kWin, 16> : &ring_align_kernel<float, kWin, 8>;
}

constexpr int kMaxSmem = 227 * 1024;

// Chooses the shape and launches one kernel over nblk kroi-blocks.
template <int kWin>
inline int launch(int is_bf16, const Buffers& bufs, Work a, int nblk, cudaStream_t stream) {
  a.s = make_shape(kWin, is_bf16 ? 2 : 4, a.kroi, a.oh, a.ow, a.tw);
  if (a.s.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long gx =
      (long long)nblk * a.s.mgroups * a.s.jgroups * ((a.channels + a.s.cs - 1) / a.s.cs);
  if (gx > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx);
  return staged::launch(kernel_for<kWin>(is_bf16, a.s.jb), grid, dim3(kThreads),
                        (size_t)a.s.smem, stream, bufs, a);
}

// Registers, local memory bytes (spills and stack) and static shared
// memory bytes per thread / block of the loaded build: the most over the
// dtype's builds (float32: 8 and 16 output columns per block).
template <int kWin>
inline int attributes(int is_bf16, int* regs, int* local, int* static_smem) {
  *regs = *local = *static_smem = 0;
  for (int jb = 8; jb <= (is_bf16 ? 8 : 16); jb += 8) {
    cudaFuncAttributes fa{};
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel_for<kWin>(is_bf16, jb));
    if (e != cudaSuccess) return (int)e;
    *regs = std::max(*regs, fa.numRegs);
    *local = std::max(*local, (int)fa.localSizeBytes);
    *static_smem = std::max(*static_smem, (int)fa.sharedSizeBytes);
  }
  return 0;
}

// The launch shape of a call: cs, ch, mt, mgroups, jgroups, slots, dynamic
// shared memory bytes, threads and resident blocks per SM, into v[0..8].
template <int kWin>
inline int shape(int is_bf16, int kroi, int out_h, int tw, int* v) {
  const Shape s = make_shape(kWin, is_bf16 ? 2 : 4, kroi, out_h, out_h, tw);
  const KernelFn k = kernel_for<kWin>(is_bf16, s.jb);
  int blocks = 0;
  if (s.smem <= kMaxSmem) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, s.smem);
    }
    if (e != cudaSuccess) return (int)e;
  }
  const int vals[9] = {s.cs, s.ch, s.mt, s.mgroups, s.jgroups, s.slots, s.smem, kThreads, blocks};
  for (int i = 0; i < 9; ++i) v[i] = vals[i];
  return 0;
}

}  // namespace ring
