// Pieces shared by the bfloat16 MLP-chain kernels (csrc/mlp_chain_fwd_bf16.cu
// and csrc/mlp_chain_bwd_bf16.cu): the rounding helpers and the tensor-core
// building blocks, a pair of warps' 16-row products on Hopper's bf16 mma.sync
// with f32 accumulators. The f32-FMA pieces of the wide path are in
// csrc/mlp_chain_bf16_fma.cuh, the launch plans in csrc/mlp_chain_bf16_plan.h.
//
// Rounding points, those of the Pallas kernel
// (npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py): x, every weight and
// every bias are rounded to bf16 before use (:184-185, :239-240; the f32
// parameters are rounded here as they are staged); a layer sums its bf16
// products in f32, adds the bias in f32, applies the ReLU in f32 and rounds
// to bf16 (:73-77); the residual adds two bf16 values and rounds (:78); the
// output (h + bout) is rounded to bf16 (:80). The backward takes its masks
// from the f32 pre-activations (:100-111), rounds every g W product to bf16
// (:121-123, :131-133), adds the residual gradient in bf16 (:134) and sums
// dW and db in f32 (:117-139).
//
// Order of the sums. A product of two bf16 values is exact in f32, so the
// tensor cores and the plain version (`_matmul_seq` in
// ops/kernels/mlp_chain.py: feature by feature in order, one f32 FMA a
// term) add the same exact terms, in other orders: an mma.sync adds a
// k-group of 16 products to its f32 accumulator in the hardware's own order
// and rounding, and the k-groups follow one another in feature order. The
// two sums differ in their last f32 bits, and where one lies at a bf16
// rounding boundary, or at zero before a ReLU, the rounded value or the mask
// would come out the other way. A hidden unit that moves carries the move to
// the later layers, and in the backward a ReLU mask that flips moves a whole
// row of dx. So the kernels take the tensor cores' sum only where it decides
// the rounding (`settle`): the distance between the two orders' sums is
// taken to be at most kFixEps ||a|| max ||w|| (2^-22 of the Cauchy-Schwarz
// bound on the sum of |products|, from the row of inputs and the largest
// weight row or column), and each pair of outputs whose interval
// [h - eps, h + eps] rounds (or, before a ReLU, clamps) to two values is
// summed again in the plain version's order, sequential FMA from the pair's
// row buffer, the pair's undecided outputs shared out over its lanes. With
// every input of a product equal to the plain version's, every rounded value
// and mask of the chain then is too, layer after layer; only the f32 row sums
// dW and db keep the tensor cores' order. The bound is an estimate, not a
// proof (the worst case of two 128-term f32 sums is some 2^-17 of it): a
// smaller one flags fewer outputs and lets more order differences through,
// which chip_smoke.py and kernel_ab.py would show as outputs that differ from
// the plain version's. The kernels are held to the bars of kernel_measure.py,
// which admit any order of the sums; every sum of a kernel runs in a fixed
// order, and the bounds are summed in fixed orders too, so two launches on
// the same inputs give the same bits.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16): lane l, g = l / 4,
// t = l % 4. A 16 x 16 (rows x k): a[0] = (g, 2t..2t+1), a[1] = (g + 8,
// 2t..), a[2] = (g, 8 + 2t..), a[3] = (g + 8, 8 + 2t..), two bf16 a
// register, the lower column in the low half; ldmatrix.x4 reads them from a
// row-major row buffer. B 16 x 8 (k x n): b[0] = (2t..2t+1, g), b[1] =
// (8 + 2t.., g); ldmatrix reads them from a weight staged [out][in], plain
// for the forward's x W^T and with .trans for the backward's g W. C 16 x 8
// f32: c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..): the epilogue writes
// the pair (g + 8 h, 8 j + 2t) of acc[j][2h..2h+1] into the pair's other row
// buffer, the next product's A.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_chain_bf16_plan.h"

namespace npf_bf16 {

constexpr int kMaxNT = kTcMaxWidth / 8;   // n8 tiles of the widest product
constexpr int kMaxKT = kTcMaxWidth / 16;  // k16 steps of the widest product

// v rounded to bf16 (round to nearest even), as an f32
__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float bf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// lo and hi rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_of(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_of(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- staging the parameters (every thread of the block takes part)

// dst[n * ld + k] = bf16(src[n * K + k]) for n < N, k < K, and zero for the
// rest of [Np) x [Kp): a weight in PyTorch's [out, in] layout, rounded as it
// is staged. Kp is a multiple of 16 and ld of 8. Each thread keeps kStageDepth
// loads in flight: the weights come from L2 at its latency.
constexpr int kStageDepth = 8;

__device__ __forceinline__ void stage_weight(__nv_bfloat16* dst, int ld,
                                             const float* __restrict__ src, int N, int K, int Np,
                                             int Kp) {
  if ((K & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    const int q = Kp / 4, total = Np * q;
    for (int e0 = threadIdx.x; e0 < total; e0 += kStageDepth * blockDim.x) {
      float4 v[kStageDepth];
#pragma unroll
      for (int u = 0; u < kStageDepth; ++u) {
        const int e = e0 + u * blockDim.x, n = e / q, k = (e - n * q) * 4;
        v[u] = e < total && n < N && k < K
                   ? __ldg(reinterpret_cast<const float4*>(src + (size_t)n * K + k))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kStageDepth; ++u) {
        const int e = e0 + u * blockDim.x, n = e / q, k = (e - n * q) * 4;
        if (e < total)
          *reinterpret_cast<uint2*>(dst + (size_t)n * ld + k) =
              make_uint2(pack(v[u].x, v[u].y), pack(v[u].z, v[u].w));
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < Np * Kp; e += blockDim.x) {
    const int n = e / Kp;
    const int k = e - n * Kp;
    const float v = n < N && k < K ? __ldg(src + (size_t)n * K + k) : 0.f;
    dst[(size_t)n * ld + k] = __float2bfloat16_rn(v);
  }
}

// dst[n] = bf16(src[n]) as an f32 for n < N, zero up to Np or for a null src
__device__ __forceinline__ void stage_bias(float* dst, const float* __restrict__ src, int N,
                                           int Np) {
  for (int n = threadIdx.x; n < Np; n += blockDim.x)
    dst[n] = src != nullptr && n < N ? bfr(__ldg(src + n)) : 0.f;
}

// ---- a pair of warps: a 16-row tile, its input rows shared in shared memory

// The two warps of a pair share a 16-row tile: each computes the outputs of
// its share of the n16 column tiles of every product, from the layer's input
// rows in a row buffer in shared memory (row-major, row stride ld, bf16),
// and writes its share of the outputs into the pair's other row buffer.
constexpr int kHalfNT = kMaxNT / 2;  // n8 tiles of a warp's share of the widest product

// The pair's barrier (named barrier 1 + pair; 64 threads)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (int)(threadIdx.x >> 6)) : "memory");
}

// This warp's share [j0, j0 + nt) of the n8 tiles of a product with n16
// tiles n16: the first warp of the pair takes the first half, rounded up
__device__ __forceinline__ void share(int n16, int& j0, int& nt) {
  const int first = (n16 + 1) / 2;
  const bool second = (threadIdx.x >> 5) & 1;
  j0 = second ? 2 * first : 0;
  nt = 2 * (second ? n16 - first : first);
}

// The bf16 pair (row, col), (row, col + 1) of a row-major [rows, N] matrix
// with row stride ld, zero outside it. vec: ld even and p 4-byte aligned.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* __restrict__ p, int ld,
                                              bool vec, int row, int col, int rows, int N) {
  if (row >= rows) return 0u;
  const __nv_bfloat16* q = p + (size_t)row * ld + col;
  if (vec && col + 1 < N) return __ldg(reinterpret_cast<const unsigned int*>(q));
  const uint32_t lo = col < N ? __bfloat16_as_ushort(__ldg(q)) : 0u;
  const uint32_t hi = col + 1 < N ? __bfloat16_as_ushort(__ldg(q + 1)) : 0u;
  return lo | hi << 16;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int ld, bool vec, int row, int col,
                                           int rows, int N, uint32_t v) {
  if (row >= rows || col >= N) return;
  __nv_bfloat16* q = p + (size_t)row * ld + col;
  if (vec && col + 1 < N) {
    *reinterpret_cast<uint32_t*>(q) = v;
    return;
  }
  q[0] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
  if (col + 1 < N) q[1] = __ushort_as_bfloat16((unsigned short)(v >> 16));
}

// This warp's share of rows [row0, row0 + 16) of a row-major [rows, K] bf16
// matrix in device memory, zero past `rows` and up to pad16(K): the pair's
// two warps share the k16 steps, and v[i] holds step kk0 + i, as the pairs
// of an A fragment. `put_rows` stores them into the row buffer; the caller
// syncs the pair after. Apart, the loads can be in flight while the block
// stages its weights.
constexpr int kShareKT = (kMaxKT + 1) / 2;

__device__ __forceinline__ void fetch_rows(uint32_t (&v)[kShareKT][4],
                                           const __nv_bfloat16* __restrict__ p, int K, bool vec,
                                           int row0, int rows) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c = 2 * (lane & 3);
  int k0, nk;
  share((K + 15) / 16, k0, nk);  // in n8 units: k16 steps [k0 / 2, (k0 + nk) / 2)
#pragma unroll
  for (int i = 0; i < kShareKT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[i][q] = 2 * i < nk ? load_pair(p, K, vec, row0 + r + (q & 1) * 8,
                                       (k0 / 2 + i) * 16 + (q >> 1) * 8 + c, rows, K)
                           : 0u;
}

__device__ __forceinline__ void put_rows(__nv_bfloat16* buf, int ld, int K,
                                         const uint32_t (&v)[kShareKT][4]) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c = 2 * (lane & 3);
  int k0, nk;
  share((K + 15) / 16, k0, nk);
#pragma unroll
  for (int i = 0; i < kShareKT; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (2 * i < nk)
        *reinterpret_cast<uint32_t*>(buf + (r + (q & 1) * 8) * ld +
                                     (k0 / 2 + i) * 16 + (q >> 1) * 8 + c) = v[i][q];
}

// The address of this lane's ldmatrix row in a staged weight w (rows of ld
// bf16), at the n8 tile j0: B(k, n) = w[n][k] (TRANS false: the forward's
// x W^T) or w[k][n] (TRANS true: the backward's g W). The two n8 tiles
// j0 + j, j0 + j + 1 of k16 step kk are at b + 2 (kk * 16 + j * 8 ld) or
// b + 2 (kk * 16 ld + j * 8).
template <bool TRANS>
__device__ __forceinline__ uint32_t b_addr(const __nv_bfloat16* w, int ld, int j0) {
  const int lane = threadIdx.x & 31;
  const int r = lane & 7, q = lane >> 3;
  return TRANS ? smem_u32(w + (r + (q & 1) * 8) * ld + j0 * 8 + (q >> 1) * 8)
               : smem_u32(w + (j0 * 8 + r + (q >> 1) * 8) * ld + (q & 1) * 8);
}

// acc (this warp's nt n8 tiles from j0) = the row buffer `in` (16 rows x 16
// kt) times B (b_addr); n0 and n1 bound ||row||_2 of the rows g and g + 8 of
// the input (squares summed in bf16 pairs, 16 terms a half, each add within
// 2^-8 of the exact sum; the sum raised by 1/8 to stay above the exact one)
template <bool TRANS>
__device__ __forceinline__ void product(float (&acc)[kHalfNT][4], const __nv_bfloat16* in, int lda,
                                        int kt, const __nv_bfloat16* w, int ld, int j0, int nt,
                                        float& n0, float& n1) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kHalfNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const uint32_t a0 = smem_u32(in + ((lane & 7) + ((lane >> 3) & 1) * 8) * lda + (lane >> 4) * 8);
  const uint32_t b0 = b_addr<TRANS>(w, ld, j0);
  __nv_bfloat162 s[2] = {__float2bfloat162_rn(0.f), __float2bfloat162_rn(0.f)};
#pragma unroll 2
  for (int kk = 0; kk < kt; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a0 + 2u * kk * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&a[q]);
      s[q & 1] = __hfma2(v, v, s[q & 1]);
    }
    uint32_t b[kHalfNT / 2][4];  // the step's B fragments, all loads issued before the products
#pragma unroll
    for (int j = 0; j < kHalfNT; j += 2) {
      if (j >= nt) break;
      if (TRANS)
        ldsm_x4_trans(b[j / 2], b0 + 2u * (kk * 16 * ld + j * 8));
      else
        ldsm_x4(b[j / 2], b0 + 2u * (j * 8 * ld + kk * 16));
    }
#pragma unroll
    for (int j = 0; j < kHalfNT; j += 2) {
      if (j >= nt) break;
      mma(acc[j], a, b[j / 2][0], b[j / 2][1]);
      mma(acc[j + 1], a, b[j / 2][2], b[j / 2][3]);
    }
  }
  float f0 = __low2float(s[0]) + __high2float(s[0]);
  float f1 = __low2float(s[1]) + __high2float(s[1]);
  f0 += __shfl_xor_sync(0xffffffffu, f0, 1);
  f0 += __shfl_xor_sync(0xffffffffu, f0, 2);
  f1 += __shfl_xor_sync(0xffffffffu, f1, 1);
  f1 += __shfl_xor_sync(0xffffffffu, f1, 2);
  n0 = sqrtf(1.125f * f0);
  n1 = sqrtf(1.125f * f1);
}

// ---- the plain version's order where the tensor cores cannot decide

constexpr float kFixEps = 2.384185791015625e-07f;  // 2^-22

// wmax[0] = max_n ||w[n, :]|| (with `cols` also wmax[1] = max_c ||w[:, c]||)
// over a staged weight [Np][Kp]; wmax starts at zero, the block's threads
// share the work: a half warp a row (eight bf16 a lane and load, the squares
// reduced over the half warp), a thread a column. Each norm is summed in a
// fixed order, so the bounds, and with them the settled sums, repeat.
__device__ __forceinline__ void stage_norm_max(float* wmax, const __nv_bfloat16* w, int ld,
                                               int Np, int Kp, bool cols) {
  const int half = threadIdx.x >> 4, hl = threadIdx.x & 15;
  float top = 0.f;  // the largest row norm this half warp saw
  for (int n0 = 0; n0 < Np; n0 += blockDim.x / 16) {  // the half warps take whole rounds
    const int n = n0 + half;
    float s = 0.f;
    if (n < Np)
      for (int k = 8 * hl; k < Kp; k += 128) {
        const uint4 v = *reinterpret_cast<const uint4*>(w + n * ld + k);
        const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s = fmaf(lo_of(x[i]), lo_of(x[i]), fmaf(hi_of(x[i]), hi_of(x[i]), s));
      }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o, 16);
    top = fmaxf(top, sqrtf(s));
  }
  top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 16));
  // non-negative floats order as their bits do; one atomic a warp
  if ((threadIdx.x & 31) == 0) atomicMax(reinterpret_cast<int*>(wmax), __float_as_int(top));
  if (!cols) return;
  top = 0.f;
  for (int c = threadIdx.x; c < Kp; c += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int n = 0; n < Np; ++n) s = fmaf(bf(w + n * ld + c), bf(w + n * ld + c), s);
    top = fmaxf(top, sqrtf(s));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
  if ((threadIdx.x & 31) == 0) atomicMax(reinterpret_cast<int*>(wmax + 1), __float_as_int(top));
}

// The plain version's sums of the outputs n and n + 1: sum_{k < K} a[k] B(k,
// n), one f32 FMA a term from zero in order k = 0, 1, ...; a is a row of a
// row buffer, B as in b_addr. K is a multiple of 16; the zero padding past
// the real width leaves the sums as they are.
template <bool TRANS>
__device__ __forceinline__ void plain_sums(const __nv_bfloat16* a, const __nv_bfloat16* w, int ld,
                                           int n, int K, float& s0, float& s1) {
  s0 = 0.f;
  s1 = 0.f;
  if (TRANS) {
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float x = bf(a + k);
      const uint32_t y = *reinterpret_cast<const uint32_t*>(w + k * ld + n);
      s0 = fmaf(x, lo_of(y), s0);
      s1 = fmaf(x, hi_of(y), s1);
    }
    return;
  }
  const __nv_bfloat16 *w0 = w + n * ld, *w1 = w0 + ld;
#pragma unroll 4
  for (int k = 0; k < K; k += 8) {
    const uint4 av = *reinterpret_cast<const uint4*>(a + k);
    const uint4 u = *reinterpret_cast<const uint4*>(w0 + k);
    const uint4 v = *reinterpret_cast<const uint4*>(w1 + k);
    const uint32_t x[4] = {av.x, av.y, av.z, av.w};
    const uint32_t y[4] = {u.x, u.y, u.z, u.w}, z[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s0 = fmaf(lo_of(x[i]), lo_of(y[i]), s0);
      s1 = fmaf(lo_of(x[i]), lo_of(z[i]), s1);
      s0 = fmaf(hi_of(x[i]), hi_of(y[i]), s0);
      s1 = fmaf(hi_of(x[i]), hi_of(z[i]), s1);
    }
  }
}

// {hi, lo} rounded to bf16 (with RELU, negatives to zero), lo in the low half
template <bool RELU>
__device__ __forceinline__ uint32_t cvt_pair(float hi, float lo) {
  uint32_t d;
  if (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

struct FixList {  // a pair's fix-up list in shared memory
  int* at;        // cap entries: row << 16 | output column
  float2* sums;   // the plain sums of the entry's two outputs
  int* count;     // [2]: each warp's number of entries
  int cap;

  // the list of the pair of warp `warp` in the block's fix-up region (L.fix)
  __device__ FixList(unsigned char* fix, int warps, int warp_cap, int warp)
      : at(reinterpret_cast<int*>(fix) + (warp & ~1) * warp_cap),
        sums(reinterpret_cast<float2*>(fix + 4 * warps * warp_cap) + (warp & ~1) * warp_cap),
        count(reinterpret_cast<int*>(fix + 12 * warps * warp_cap) + (warp & ~1)),
        cap(2 * warp_cap) {}
};

// Settles this warp's share of a product. On entry acc[j][e] holds the
// tensor cores' sums (nt n8 tiles from j0; N real columns, the rest zero
// padding) of rows g and g + 8 of the row buffer `rows` (row stride lda)
// times B (as in b_addr, depth K); eps0 and
// eps1 bound, for the two rows, how far such a sum may lie from the plain
// version's (kFixEps ||row|| max ||B column||). `bias` (may be null) is
// added. Every pair of outputs (n, n + 1) of a row whose rounding (RELU:
// whose ReLU and rounding) a value within eps could change is summed again
// in the plain version's order: the pair of warps gathers its undecided
// outputs in `fix` and shares them out, 32 entries a warp, so that as few
// warps as possible run the sequential sums. Both warps of the pair call it.
template <bool TRANS, bool RELU>
__device__ __forceinline__ void settle(float (&acc)[kHalfNT][4], int nt, int j0, int N,
                                       const float* bias, float eps0, float eps1,
                                       const __nv_bfloat16* rows, int lda,
                                       const __nv_bfloat16* w, int ld, int K, FixList fix) {
  const int lane = threadIdx.x & 31, half = (threadIdx.x >> 5) & 1;
  const int g = lane >> 2, c = 2 * (lane & 3) + 8 * j0;
  uint32_t todo = 0;  // bit 2 j + h: the pair of tile j0 + j, row g + 8 h
#pragma unroll
  for (int j = 0; j < kHalfNT; ++j) {
    if (j >= nt) break;
    if (bias != nullptr) {
      const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + c);
      acc[j][0] += b.x;
      acc[j][1] += b.y;
      acc[j][2] += b.x;
      acc[j][3] += b.y;
    }
    if (j * 8 + c >= N) continue;  // zero padding: exact zeros, never stored
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float e = h ? eps1 : eps0;
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      if (cvt_pair<RELU>(v1 - e, v0 - e) != cvt_pair<RELU>(v1 + e, v0 + e))
        todo |= 1u << (2 * j + h);
    }
  }
  const int mine = __popc(todo);
  int upto = mine;  // inclusive prefix of the warp's lanes' counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += v;
  }
  if (lane == 31) fix.count[half] = upto;
  pair_sync();
  const int first = fix.count[0], total = first + fix.count[1];
  for (int start = 0; start < total; start += fix.cap) {
    int slot = (half ? first : 0) + upto - mine - start;
    for (uint32_t t = todo; t != 0; t &= t - 1, ++slot) {
      const int b = __ffs(t) - 1;
      if (slot >= 0 && slot < fix.cap)
        fix.at[slot] = (g + 8 * (b & 1)) << 16 | ((b >> 1) * 8 + c);
    }
    pair_sync();
    // entries 32 i + lane to warp i % 2: below 32 entries the second warp idles
    for (int i = 32 * half + lane; i < min(fix.cap, total - start); i += 64) {
      const int row = fix.at[i] >> 16, n = fix.at[i] & 0xffff;
      float s0, s1;
      plain_sums<TRANS>(rows + row * lda, w, ld, n, K, s0, s1);
      if (bias != nullptr) {
        s0 += bias[n];
        s1 += bias[n + 1];
      }
      fix.sums[i] = make_float2(s0, s1);
    }
    pair_sync();
    slot = (half ? first : 0) + upto - mine - start;
    for (uint32_t t = todo; t != 0; t &= t - 1, ++slot) {
      if (slot < 0 || slot >= fix.cap) continue;
      const int b = __ffs(t) - 1;
      const float2 f = fix.sums[slot];
#pragma unroll
      for (int j = 0; j < kHalfNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (2 * j + h == b) {
            acc[j][2 * h] = f.x;
            acc[j][2 * h + 1] = f.y;
          }
    }
    pair_sync();
  }
}

// ---- epilogues (this warp's share: nt n8 tiles from j0; pair (j, h) holds
// the columns 8 (j0 + j) + 2 t, + 1 of row g + 8 h)

// A hidden layer: h = acc (its sums and bias, settled), a = bf16(relu(h)),
// with `res` a = bf16(a + the layer's input, read from `in`), into the row
// buffer `out` and, when `scratch` is given, into rows [row0, row0 + 16) of
// it (row stride lds, rows < M). Returns the ReLU mask: bit 2 (2 j + h) + i
// for output i of pair (j, h).
__device__ __forceinline__ uint32_t epi_hidden(const float (&acc)[kHalfNT][4], int nt, int j0,
                                               bool res, const __nv_bfloat16* in,
                                               __nv_bfloat16* out, int ld,
                                               __nv_bfloat16* scratch, int lds, int row0, int M) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = 2 * (lane & 3) + 8 * j0;
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kHalfNT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      bits |= (v0 > 0.f ? 1u : 0u) << (4 * j + 2 * h);
      bits |= (v1 > 0.f ? 1u : 0u) << (4 * j + 2 * h + 1);
      const int at = (g + 8 * h) * ld + j * 8 + c;
      uint32_t a;
      if (res) {
        const uint32_t old = *reinterpret_cast<const uint32_t*>(in + at);
        a = pack(bfr(fmaxf(v0, 0.f)) + lo_of(old), bfr(fmaxf(v1, 0.f)) + hi_of(old));
      } else {
        a = cvt_pair<true>(v1, v0);
      }
      *reinterpret_cast<uint32_t*>(out + at) = a;
      if (scratch != nullptr && row0 + g + 8 * h < M)
        *reinterpret_cast<uint32_t*>(scratch + (size_t)(row0 + g + 8 * h) * lds + j * 8 + c) = a;
    }
  }
  return bits;
}

// A gradient: g = bf16(acc), with `res` g = bf16(g + the layer's output
// gradient, which `g` holds on entry); g[j][h] packs pair (j, h)
__device__ __forceinline__ void epi_grad(const float (&acc)[kHalfNT][4], uint32_t (&g)[kHalfNT][2],
                                         int nt, bool res) {
#pragma unroll
  for (int j = 0; j < kHalfNT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      g[j][h] = res ? pack(bfr(acc[j][2 * h]) + lo_of(g[j][h]),
                           bfr(acc[j][2 * h + 1]) + hi_of(g[j][h]))
                    : cvt_pair<false>(acc[j][2 * h + 1], acc[j][2 * h]);
  }
}

// p = g m (the elements whose mask bit is clear zeroed) into the row buffer
// `out` and into rows [row0, row0 + 16) of `scratch` (row stride lds, rows <
// M)
__device__ __forceinline__ void put_masked(const uint32_t (&g)[kHalfNT][2], uint32_t mask, int nt,
                                           int j0, __nv_bfloat16* out, int ld,
                                           __nv_bfloat16* scratch, int lds, int row0, int M) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, c = 2 * (lane & 3) + 8 * j0;
#pragma unroll
  for (int j = 0; j < kHalfNT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bit = 4 * j + 2 * h;
      const uint32_t keep =
          ((mask >> bit) & 1u ? 0x0000ffffu : 0u) | ((mask >> (bit + 1)) & 1u ? 0xffff0000u : 0u);
      const uint32_t p = g[j][h] & keep;
      *reinterpret_cast<uint32_t*>(out + (gr + 8 * h) * ld + j * 8 + c) = p;
      if (row0 + gr + 8 * h < M)
        *reinterpret_cast<uint32_t*>(scratch + (size_t)(row0 + gr + 8 * h) * lds + j * 8 + c) = p;
    }
  }
}

}  // namespace npf_bf16
