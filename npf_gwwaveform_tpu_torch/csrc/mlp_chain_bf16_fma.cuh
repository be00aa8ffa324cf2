// The f32-FMA pieces of the bfloat16 MLP-chain kernels' wide path (the
// K2-bf16 and K3-bf16 rows kernels for chains wider than the tensor-core
// kernels hold, csrc/mlp_chain_bf16_plan.h): the row-tile layout, the
// staging of a bf16 row tile into shared memory, and the register-tiled
// product whose f32 sums run feature by feature in order, the order of the
// plain version (`_matmul_seq` in ops/kernels/mlp_chain.py), so that on this
// path a kernel and its plain version give the same bits.
//
// Layout of a block: 256 threads, 8 warps; warp w owns the tile rows
// [w RM, (w + 1) RM) and lane l the columns {n0 + 4 l + j, j < 4} of each
// 128-column pass: acc[i][j]. A tile's activations and gradients are kept in
// shared memory as f32 holding bf16 values, transposed (at[k * LDA + row]),
// so a reduction step is RM / 4 broadcast float4 loads of the activations
// and one float4 load of the staged weights for 4 RM FMAs. Weights go
// through shared memory in chunks of kKC reduction features x 128 columns,
// rounded to bf16 as they are staged; the next chunk's loads are issued
// before the current chunk's FMAs.

#pragma once

#include "mlp_chain_bf16.cuh"

namespace npf_bf16 {

constexpr int kPer = kKC * kTN / kThreads;  // staged values a thread

template <int RM>
struct Rows {
  static_assert(RM % 4 == 0, "rows a thread come in float4s");
  static constexpr int TM = 8 * RM;    // rows a block
  static constexpr int LDA = TM + 4;   // float4-aligned
};

// dst[c * LDA + r] = src[(row0 + r) * K + c] for r < TM, c < K (zero past M)
template <int RM>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* __restrict__ src,
                                           int row0, int M, int K) {
  constexpr int TM = Rows<RM>::TM;
  for (int e = threadIdx.x; e < TM * K; e += kThreads) {
    const int r = e / K;
    const int c = e - r * K;
    dst[c * Rows<RM>::LDA + r] = row0 + r < M ? bf(src + (size_t)(row0 + r) * K + c) : 0.f;
  }
}

// A thread's share of a staged chunk: W(k0 + kk, n0 + nn) rounded to bf16,
// zero outside [0, K) x [0, N). TRANS: W(k, n) = w[n * K + k] (PyTorch's
// [out, in] layout read as its transpose, the forward's operand); else
// W(k, n) = w[k * N + n] (the backward's).
template <bool TRANS>
__device__ __forceinline__ void load_chunk(float (&v)[kPer], const float* __restrict__ w, int K,
                                           int N, int k0, int n0) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int kk = TRANS ? e % kKC : e / kTN;
    const int nn = TRANS ? e / kKC : e % kTN;
    const int k = k0 + kk, n = n0 + nn;
    v[u] = k < K && n < N ? bfr(__ldg(w + (TRANS ? (size_t)n * K + k : (size_t)k * N + n))) : 0.f;
  }
}

template <bool TRANS>
__device__ __forceinline__ void store_chunk(float* bs, const float (&v)[kPer]) {
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int kk = TRANS ? e % kKC : e / kTN;
    const int nn = TRANS ? e / kKC : e % kTN;
    bs[kk * kLdb + nn] = v[u];
  }
}

// For the tile's rows r and every n < N, in passes of 128 columns:
//   acc = sum_{k < K} at[k * LDA + r] * W(k, n), added in order k = 0, 1, ...
// from zero with one f32 FMA a term, then epi(r, n, acc). Begins with a
// barrier, so `at` may have been written just before; epi runs after every
// read of `at` of its pass, and may write anywhere but `at` and `bs`.
template <int RM, bool TRANS, typename Epi>
__device__ __forceinline__ void product(const float* at, const float* __restrict__ w, int K, int N,
                                        float* bs, Epi epi) {
  constexpr int LDA = Rows<RM>::LDA;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int n0 = 0; n0 < N; n0 += kTN) {
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float v[kPer];
    if (K > 0) load_chunk<TRANS>(v, w, K, N, 0, n0);
    for (int k0 = 0; k0 < K; k0 += kKC) {
      __syncthreads();  // every read of bs (and the writes of `at`) before are done
      store_chunk<TRANS>(bs, v);
      __syncthreads();
      if (k0 + kKC < K) load_chunk<TRANS>(v, w, K, N, k0 + kKC, n0);  // in flight during the FMAs
      const int kn = min(kKC, K - k0);
      const float* a = at + (size_t)k0 * LDA + warp * RM;
      const float* b = bs + 4 * lane;
      for (int kk = 0; kk < kn; ++kk) {
        float av[RM];
#pragma unroll
        for (int q = 0; q < RM / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(a + kk * LDA + 4 * q);
          av[4 * q] = t.x;
          av[4 * q + 1] = t.y;
          av[4 * q + 2] = t.z;
          av[4 * q + 3] = t.w;
        }
        const float4 t = *reinterpret_cast<const float4*>(b + kk * kLdb);
        const float bv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // with K = 0 no barrier ran above
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * lane + j;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < RM; ++i) epi(warp * RM + i, n, acc[i][j]);
    }
  }
}

}  // namespace npf_bf16
