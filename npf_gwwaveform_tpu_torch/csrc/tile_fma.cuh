// Pieces shared by the port's sm_90a kernels (csrc/mlp_chain_bwd.cu and
// csrc/setconv_fwd.cu): cp.async staging of row-major tiles into shared
// memory, and the register-tiled f32 FMA step of a 128-thread block whose
// output tile is (8 * RM) rows x 128 columns.
//
// The FMA step's layout. Thread (rg, cg), with rg = 4 * (warp >> 1) +
// (lane >> 3) in 0..7 and cg = 8 * (warp & 1) + (lane & 7) in 0..15, owns
// rows {32 q + 4 rg + i} (q < RM / 4, i < 4) and columns {64 h + 4 cg + j}
// (h < 2, j < 4): acc[4 q + i][4 h + j]. The left operand is stored
// transposed in shared memory (at[k * ld + row]) and the right one as is
// (b[k * ld + col]), so each reduction step is RM / 4 + 2 float4 loads for
// 8 * RM FMAs. A warp covers 4 row groups and 8 column groups: its left
// loads touch 4 distinct float4s and its right loads 8, one shared-memory
// wavefront each, which keeps the FMA pipe, not shared memory, the limit
// at RM = 8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace npf {

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// waits until at most N of this thread's newest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// 16-byte copies are possible from src[r * ld + c0 ...] when every such
// float4 lies wholly inside or wholly outside the n_cols valid columns
__device__ __forceinline__ bool can_vec(const float* src, int ld, int c0, int n_cols) {
  return ld % 4 == 0 && c0 % 4 == 0 && n_cols % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// Starts the copy dst[i * dst_ld + j] = src[(r0 + i) * ld + c0 + j] for
// i < ROWS, j < COLS, zero-filled where r0 + i >= n_rows or c0 + j >= n_cols
// (dst_ld a multiple of 4, dst 16-byte aligned). The caller commits and waits.
template <int ROWS, int COLS, int NTHREADS>
__device__ __forceinline__ void stage_tile(float* dst, int dst_ld, const float* src, int ld,
                                           int r0, int n_rows, int c0, int n_cols, bool vec) {
  if (vec) {
    constexpr int kPerRow = COLS / 4;
    for (int e = threadIdx.x; e < ROWS * kPerRow; e += NTHREADS) {
      const int i = e / kPerRow;
      const int j = 4 * (e - i * kPerRow);
      const bool ok = r0 + i < n_rows && c0 + j < n_cols;
      cp_async16(dst + i * dst_ld + j, ok ? src + (size_t)(r0 + i) * ld + c0 + j : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += NTHREADS) {
      const int i = e / COLS;
      const int j = e - i * COLS;
      const bool ok = r0 + i < n_rows && c0 + j < n_cols;
      cp_async4(dst + i * dst_ld + j, ok ? src + (size_t)(r0 + i) * ld + c0 + j : src, ok);
    }
  }
}

__device__ __forceinline__ int tile_rg() {
  return 4 * (threadIdx.x >> 6) + ((threadIdx.x & 31) >> 3);
}

__device__ __forceinline__ int tile_cg() {
  return 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7);
}

// acc[4 q + i][4 h + j] += sum_{kk < KSTEPS} at[kk * at_ld + 32 q + 4 rg + i]
//                                          * b[kk * b_ld + 64 h + 4 cg + j]
template <int RM, int KSTEPS>
__device__ __forceinline__ void fma_tile(float (&acc)[RM][8], const float* at, int at_ld,
                                         const float* b, int b_ld, int rg, int cg) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    float av[RM], bv[8];
#pragma unroll
    for (int q = 0; q < RM / 4; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(at + kk * at_ld + 32 * q + 4 * rg);
      av[4 * q] = t.x;
      av[4 * q + 1] = t.y;
      av[4 * q + 2] = t.z;
      av[4 * q + 3] = t.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(b + kk * b_ld + 4 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(b + kk * b_ld + 64 + 4 * cg);
    bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
    bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Writes the 4 x 4 block v (rows grow0 + i, columns n0 + j) into the
// row-major dst [n_rows, ld], skipping rows >= n_rows and columns >= n_cols.
__device__ __forceinline__ void store_block(float* dst, int ld, int grow0, int n_rows, int n0,
                                            int n_cols, const float (&v)[4][4]) {
  const bool vec = n0 + 3 < n_cols && ld % 4 == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (grow0 + i >= n_rows) continue;
    float* p = dst + (size_t)(grow0 + i) * ld + n0;
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < n_cols) p[j] = v[i][j];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace npf
