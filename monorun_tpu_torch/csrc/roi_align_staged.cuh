// Shared pieces of the staged RoIAlign kernels for Hopper (sm_90a):
// roi_align_tile.cu, roi_align_band.cu and roi_align_mma.cu.
//
// All of them compute, for each RoI (a "slot" of the prepared inputs),
//   out[i][j][c] = sum_w X[j][w] sum_r Y[i][r] window[r][w][c]
// over a (rows x columns) window of one level buffer of the
// dual-orientation flat pyramid (monorun_tpu_torch/ops/roi_align_tile.py:
// prepare_flat_pyramid; buffers are (rows, cols, C), channels last). Y and X
// come from roi_tile_geometry in the features' dtype; sums are float32.
// Each kernel stages windows of the buffer into shared memory for one
// channel slice of `cs` channels (32 bytes of each buffer cell when it
// fits), keeps the per-RoI sums in shared memory as acc[j][i][c], and at
// the end writes each RoI into its output row `dst` and orientation
// (transposed RoIs read the transposed buffer: output[j][i] = acc[j][i]).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace staged {

constexpr int kMaxBufs = 10;           // 2 orientations x 5 levels
constexpr int kRowBlk = 16;            // rows per register block of sums
constexpr int kColBlk = 32;            // columns per staged chunk (tile, band)
constexpr int kSmemBudget = 200 * 1024;

struct Buffers {
  const void* ptr[kMaxBufs];
  int rows[kMaxBufs];
  int cols[kMaxBufs];
};

inline int make_buffers(Buffers* b, const void* const* ptrs, const int* rows,
                        const int* cols, int nbufs) {
  if (nbufs < 1 || nbufs > kMaxBufs) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nbufs; ++i) {
    b->ptr[i] = ptrs[i];
    b->rows[i] = rows[i];
    b->cols[i] = cols[i];
  }
  return 0;
}

// The largest channel slice (32 bytes of a cell down to 4) that divides C
// and whose shared memory fits the budget; 0 if none.
template <typename F>
inline int pick_slice(int channels, int elt, F smem_bytes) {
  for (int cs = 32 / elt; cs * elt >= 4; cs /= 2) {
    if (channels % cs == 0 && smem_bytes(cs) <= kSmemBudget) return cs;
  }
  return 0;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// d += A @ B for one 16x8 tile, K = 16: bfloat16 in, float32 sums; a and b
// in the fragment layout of mma.sync m16n8k16.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

// Waits for this thread's copies; the caller then synchronises the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Starts copies of rows [row0, row0 + nrows) x columns [col0, col0 + ncols)
// x channels [cs0, cs0 + cs) of a (rows, buf_cols, C) buffer into shared
// memory laid out [row][col][channel] with `scols` columns per row.
template <typename T>
__device__ void stage_window(T* smem, int scols, const T* buf, int buf_cols, int channels,
                             int row0, int nrows, int col0, int ncols, int cs0, int cs) {
  const int seg = cs * (int)sizeof(T);
  const int vec = seg % 16 == 0 ? 16 : (seg % 8 == 0 ? 8 : 4);
  const int per = seg / vec;
  const int total = nrows * ncols * per;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int v = t % per;
    const int rc = t / per;
    const int w = rc % ncols, r = rc / ncols;
    const char* src = reinterpret_cast<const char*>(
        buf + ((long long)(row0 + r) * buf_cols + (col0 + w)) * channels + cs0) + v * vec;
    char* dst = reinterpret_cast<char*>(smem + ((long long)r * scols + w) * cs) + v * vec;
    cp_async(dst, src, vec);
  }
}

__device__ __forceinline__ void zero_shared(float* p, int count) {
  for (int t = threadIdx.x; t < count; t += blockDim.x) p[t] = 0.f;
}

// CUDA-core sums of one RoI over one staged window, for output column j and
// channel c: rows are the RoI's window rows wr0 + [0, 16 * row_blocks)
// (all staged, from staged row s_row0), columns [wlo, whi) (staged from
// column s_col0); Y is (oh, th) with window origin wr0, X (ow, tw) with
// window origin wc0. Adds into acc[(j * oh + i) * cs + c].
template <typename T>
__device__ void accumulate_rows(float* acc, const T* s, int s_row0, int s_col0, int scols,
                                int cs, int c, int j, const T* Y, int th, int wr0,
                                int row_blocks, const T* X, int tw, int wc0, int wlo, int whi,
                                int oh) {
  for (int q = 0; q < row_blocks; ++q) {
    float u[kRowBlk];
#pragma unroll
    for (int rr = 0; rr < kRowBlk; ++rr) u[rr] = 0.f;
    const T* base = s + ((long long)(wr0 + q * kRowBlk - s_row0) * scols - s_col0) * cs + c;
    for (int w = wlo; w < whi; ++w) {
      const float xw = to_float(X[j * tw + (w - wc0)]);
      const T* sp = base + (long long)w * cs;
#pragma unroll
      for (int rr = 0; rr < kRowBlk; ++rr) u[rr] += xw * to_float(sp[(long long)rr * scols * cs]);
    }
    const T* yq = Y + q * kRowBlk;
    for (int i = 0; i < oh; ++i) {
      float a = 0.f;
#pragma unroll
      for (int rr = 0; rr < kRowBlk; ++rr) a += to_float(yq[i * th + rr]) * u[rr];
      acc[(j * oh + i) * cs + c] += a;
    }
  }
}

// Writes one RoI's sums acc[j][i][c] to out[dst] (n, oh, ow, C), in its
// orientation, for channels [cs0, cs0 + cs).
template <typename T>
__device__ void write_roi(T* out, const float* acc, long long dst, int trans, int channels,
                          int cs0, int cs, int oh, int ow) {
  for (int t = threadIdx.x; t < ow * oh * cs; t += blockDim.x) {
    const int c = t % cs;
    const int ji = t / cs;
    const int i = ji % oh, j = ji / oh;
    const int p = trans ? j : i, q = trans ? i : j;
    store(out + ((dst * oh + p) * ow + q) * channels + cs0 + c, acc[t]);
  }
}

// Sets the kernel's dynamic shared memory limit and launches it.
template <typename K, typename... Args>
inline int launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                  Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace staged
