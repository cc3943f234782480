// Shared pieces of the staged RoIAlign kernels for Hopper (sm_90a): the
// level buffers, conversions, the m16n8k16 mma and the cp.async copy used
// by the staged core roi_align_ring.cuh and its launchers
// (roi_align_tile.cu, roi_align_band.cu, roi_align_mma.cu).
//
// All of them compute, for each RoI (a "slot" of the prepared inputs),
//   out[i][j][c] = sum_w X[j][w] sum_r Y[i][r] window[r][w][c]
// over a (rows x columns) window of one level buffer of the
// dual-orientation flat pyramid (monorun_tpu_torch/ops/roi_align_tile.py:
// prepare_flat_pyramid; buffers are (rows, cols, C), channels last). Y and X
// come from roi_tile_geometry in the features' dtype; sums are float32.
// Each RoI is written into its output row and orientation (transposed RoIs
// read the transposed buffer: output[j][i] = sums[i][j]).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace staged {

constexpr int kMaxBufs = 10;           // 2 orientations x 5 levels
constexpr int kRowBlk = 16;            // rows of a row block of a window (tile tier)
constexpr int kColBlk = 32;            // columns of a column block of a window (tier)

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

// Starts a 16-byte copy from device memory into shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
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
