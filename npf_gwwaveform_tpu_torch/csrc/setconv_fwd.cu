// ExpRBF SetConv forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   npf_gwwaveform_tpu/ops/pallas/setconv_kernel.py::_fwd_kernel
//   (launcher _setconv_pallas_fwd_impl, entry setconv_exprbf_pallas).
//
// Per batch row b and query q, over the keys k whose mask is set:
//   logit[k] = -(|keys[b,k] - queries[b,q]| / sigma)^p
//   signal   = sum_k softmax(logit)[k] * values[b,k,:]   (max-subtracted softmax)
//   density  = sum_k exp(logit[k])                       (raw exp, no max subtraction)
// A row whose keys are all masked gives 0 signal and 0 density, never NaN.
//
// What bounds it on the H100: per (query, real key) pair the weighted sum is
// 2 C flop and the logit and its exp about ten more. At the
// grid->target shape of the flagship path (K = 384 real keys, Q = 256,
// C = 128) that is ~25 MFLOP a batch row against ~0.33 MB of inputs and
// outputs: bound by f32 operations, the weighted sum being 96% of them. At
// the context->grid shape (C = 1, K = 256 of which U{0..192} real, Q = 384)
// the exps are the work, and the value reads and signal writes are small.
//
// Two designs, chosen by the channel count.
//
// The max first. A query's largest logit is that of its nearest real key
// (the logit falls with the distance), so a pass over the keys alone, with
// no exp, finds it; then every softmax weight exp(logit - max) is final when
// it is made and no accumulator is ever rescaled, and the density follows as
// exp(max) * sum_k exp(logit - max): one exp per pair, where the first version
// took two and rescaled per chunk.
//
// Wide (C > 8): the shape of a flash-attention forward, with the distance
// logit in place of Q K^T. One block of 128 threads per (batch row, 64
// queries, 128 channels), or 32 queries when 64-query blocks would leave
// fewer than two a SM (the batch-32 training step). After the max pass, keys,
// mask and values stream through shared memory in chunks of 32 keys with
// cp.async double buffering; the block writes the chunk's 32 x 64 softmax
// weights exp(logit - max) to shared memory (transposed), and P V runs as a
// register-tiled product: each thread keeps an 8 (or 4) queries x 8 channels
// f32 accumulator in registers (tile_fma.cuh), where the first version kept the
// 32 x C accumulator in shared memory and read both FMA operands from there.
// 44 KB of static shared memory. Results must match f32 at 1e-5, so tensor
// cores would need split 3xTF32 products (see csrc/mlp_chain_bwd.cu); this
// version stays on FMA.
//
// Narrow (C <= 8, the context->grid launch): one warp per 4 queries, keys
// across the lanes, the sums in registers. After the max pass, the block
// packs each chunk of 256 keys down to its real keys in shared memory (a
// ballot and a prefix count), so that no lane idles on a masked key (on the
// path, 0-75% of the context points are real); each lane sums the weights
// and the C weighted values of its keys per query, and the lanes' sums meet
// in a fixed shuffle tree. Two barriers per 256 keys, where the first
// version ran the wide block with 32 of its 256 threads busy and three
// barriers per 64 keys.
//
// Both sum in a fixed order: two launches on the same inputs give the same
// bits.

#include <cuda_runtime.h>
#include <math.h>

#include "tile_fma.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the masked logit of the Pallas kernel

// The logit with the plain version's rounding: |k - q| / sigma, then its
// square (or power), each rounded on its own. The explicit intrinsics keep
// the compiler from fusing them, or the subtraction of the max, into an FMA:
// at logits near -1e4 one such fused rounding moves a softmax weight by 0.2%.
__device__ __forceinline__ float logit_of_dist(float dist, float sigma, int p) {
  const float u = __fdiv_rn(dist, sigma);
  return p == 2 ? -__fmul_rn(u, u) : -powf(u, (float)p);
}

__device__ __forceinline__ float logit(float k, float q, float sigma, int p) {
  return logit_of_dist(fabsf(__fsub_rn(k, q)), sigma, p);
}

// ---- wide ----
constexpr int kThreads = 128;
constexpr int kTC = 128;         // channels per block
constexpr int kKC = 32;          // keys per staged chunk
constexpr int kVLd = kTC + 4;
constexpr int kMinBlocksPerSm = 2;  // below this many 64-query blocks a SM, use 32-query ones

// RM / 4 groups of 32 queries a block (RM = 8: 64 queries, RM = 4: 32)
template <int RM>
__global__ void __launch_bounds__(kThreads)
setconv_fwd_wide(const float* __restrict__ keys, const float* __restrict__ queries,
                 const float* __restrict__ values, const float* __restrict__ mask,
                 const float* __restrict__ sigma_ptr, int K, int Q, int C, int p,
                 float* __restrict__ out_sig, float* __restrict__ out_den) {
  constexpr int TQ = 8 * RM;           // queries per block
  constexpr int PLD = TQ + 4;
  constexpr int TPQ = kThreads / TQ;   // threads a query in the max pass and the weights
  __shared__ __align__(16) float ps[kKC * PLD];       // softmax weights [key][query]
  __shared__ __align__(16) float vs[2][kKC * kVLd];   // values [key][channel]
  __shared__ __align__(16) float ks[2][kKC];
  __shared__ __align__(16) float ms[2][kKC];
  __shared__ float q_s[TQ], max_s[TQ], l_s[TPQ][TQ];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int c0 = blockIdx.z * kTC;
  const int tid = threadIdx.x;
  const float sigma = *sigma_ptr;
  const float* keys_b = keys + (size_t)b * K;
  const float* mask_b = mask + (size_t)b * K;
  const float* values_b = values + (size_t)b * K * C;
  const bool vec = npf::can_vec(values_b, C, c0, C);
  const int n_chunks = (K + kKC - 1) / kKC;

  auto stage = [&](int c) {
    const int k0 = c * kKC;
    npf::stage_tile<kKC, kTC, kThreads>(vs[c & 1], kVLd, values_b, C, k0, K, c0, C, vec);
    if (tid < kKC) {  // keys past K read as masked
      npf::cp_async4(&ks[c & 1][tid], keys_b + (k0 + tid < K ? k0 + tid : 0), k0 + tid < K);
      npf::cp_async4(&ms[c & 1][tid], mask_b + (k0 + tid < K ? k0 + tid : 0), k0 + tid < K);
    }
    npf::cp_async_commit();
  };
  stage(0);

  // each query's max logit: the logit of its nearest real key, TPQ
  // neighbouring threads a query
  {
    const int qi = tid / TPQ;
    const int qg = q0 + qi;
    const float qv = qg < Q ? queries[(size_t)b * Q + qg] : 0.f;
    float dmin = INFINITY;
    for (int k = tid % TPQ; k < K; k += TPQ)
      if (mask_b[k] > 0.5f) dmin = fminf(dmin, fabsf(__fsub_rn(keys_b[k], qv)));
#pragma unroll
    for (int o = 1; o < TPQ; o <<= 1) dmin = fminf(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
    if (tid % TPQ == 0) {
      q_s[qi] = qv;
      max_s[qi] = dmin < INFINITY ? logit_of_dist(dmin, sigma, p) : kNeg;
    }
  }

  const int rg = npf::tile_rg();
  const int cg = npf::tile_cg();
  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int pq = tid % TQ;  // the query whose weights this thread writes
  float l_part = 0.f;       // and its share of their sum
  for (int c = 0; c < n_chunks; ++c) {
    npf::cp_async_wait_all();
    __syncthreads();  // chunk c is visible; the product of chunk c - 1 is done
    if (c + 1 < n_chunks) stage(c + 1);
    const float qv = q_s[pq];
    const float mq = max_s[pq];
#pragma unroll
    for (int kk = tid / TQ; kk < kKC; kk += TPQ) {
      const bool on = ms[c & 1][kk] > 0.5f;
      const float w = on ? expf(__fsub_rn(logit(ks[c & 1][kk], qv, sigma, p), mq)) : 0.f;
      ps[kk * PLD + pq] = w;
      l_part += w;
    }
    __syncthreads();
    npf::fma_tile<RM, kKC>(acc, ps, PLD, vs[c & 1], kVLd, rg, cg);
  }
  l_s[tid / TQ][pq] = l_part;
  __syncthreads();

  // density = sum_k exp(logit) = exp(max) * sum_k exp(logit - max)
  if (tid < TQ) {
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < TPQ; ++t) l += l_s[t][tid];
    q_s[tid] = l;
    if (blockIdx.z == 0 && q0 + tid < Q) out_den[(size_t)b * Q + q0 + tid] = expf(max_s[tid]) * l;
  }
  __syncthreads();
  float* sig_b = out_sig + (size_t)b * Q * C;
#pragma unroll
  for (int q = 0; q < RM / 4; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r0 = 32 * q + 4 * rg;
      const int col0 = c0 + 64 * h + 4 * cg;
      if (col0 >= C) continue;
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float inv = 1.f / fmaxf(q_s[r0 + i], 1e-30f);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = acc[4 * q + i][4 * h + j] * inv;
      }
      npf::store_block(sig_b, C, q0 + r0, Q, col0, C, v);
    }
}

// ---- narrow ----
constexpr int kNarrowC = 8;
constexpr int kNThreads = 256;                   // also the keys of one compacted chunk
constexpr int kQPerWarp = 4;
constexpr int kNQ = kNThreads / 32 * kQPerWarp;  // queries per block

__global__ void __launch_bounds__(kNThreads)
setconv_fwd_narrow(const float* __restrict__ keys, const float* __restrict__ queries,
                   const float* __restrict__ values, const float* __restrict__ mask,
                   const float* __restrict__ sigma_ptr, int K, int Q, int C, int p,
                   float* __restrict__ out_sig, float* __restrict__ out_den) {
  __shared__ float ck[kNThreads];              // the chunk's real keys, in key order
  __shared__ float cv[kNThreads * kNarrowC];   // and their values
  __shared__ int warp_real[kNThreads / 32];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = blockIdx.x * kNQ + warp * kQPerWarp;
  const float sigma = *sigma_ptr;
  const float* keys_b = keys + (size_t)b * K;
  const float* mask_b = mask + (size_t)b * K;
  const float* values_b = values + (size_t)b * K * C;

  // pass 1: each query's nearest real key, hence its max logit
  float qv[kQPerWarp], m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kNarrowC];
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    qv[i] = qb + i < Q ? queries[(size_t)b * Q + qb + i] : 0.f;
    m[i] = INFINITY;
  }
  for (int k = lane; k < K; k += 32) {
    if (!(mask_b[k] > 0.5f)) continue;
    const float kv = keys_b[k];
#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) m[i] = fminf(m[i], fabsf(__fsub_rn(kv, qv[i])));
  }
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m[i] = fminf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
    m[i] = m[i] < INFINITY ? logit_of_dist(m[i], sigma, p) : kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNarrowC; ++c) acc[i][c] = 0.f;
  }

  // pass 2, per chunk of 256 keys: the block packs the chunk's real keys
  // and values into shared memory in key order, then each lane sums the
  // softmax weights exp(logit - max) and the weighted values of its share
  // of them, every lane busy however sparse the mask
  for (int k0 = 0; k0 < K; k0 += kNThreads) {
    const int k = k0 + tid;
    const bool real = k < K && mask_b[k] > 0.5f;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    __syncthreads();  // the previous chunk's readers are done
    if (lane == 0) warp_real[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u)), n_real = 0;
    for (int w = 0; w < kNThreads / 32; ++w) {
      if (w < warp) pos += warp_real[w];
      n_real += warp_real[w];
    }
    if (real) {
      ck[pos] = keys_b[k];
#pragma unroll
      for (int c = 0; c < kNarrowC; ++c)
        if (c < C) cv[pos * kNarrowC + c] = values_b[(size_t)k * C + c];
    }
    __syncthreads();
    for (int j = lane; j < n_real; j += 32) {
      const float kv = ck[j];
#pragma unroll
      for (int i = 0; i < kQPerWarp; ++i) {
        const float e = expf(__fsub_rn(logit(kv, qv[i], sigma, p), m[i]));
        l[i] += e;
#pragma unroll
        for (int c = 0; c < kNarrowC; ++c)
          if (c < C) acc[i][c] = fmaf(e, cv[j * kNarrowC + c], acc[i][c]);
      }
    }
  }
  // the lanes' sums: a fixed butterfly, the same on every launch
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    l[i] = npf::warp_sum(l[i]);
#pragma unroll
    for (int c = 0; c < kNarrowC; ++c)
      if (c < C) acc[i][c] = npf::warp_sum(acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int qg = qb + i;
    if (lane != i || qg >= Q) continue;
    // density = sum_k exp(logit) = exp(max) * sum_k exp(logit - max)
    out_den[(size_t)b * Q + qg] = expf(m[i]) * l[i];
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNarrowC; ++c)
      if (c < C) out_sig[((size_t)b * Q + qg) * C + c] = acc[i][c] * inv;
  }
}

}  // namespace

// keys [B,K], queries [B,Q], values [B,K,C], mask [B,K] (1.0 = real key), sigma [1],
// all float32, contiguous, on the current device -> out_sig [B,Q,C], out_den [B,Q].
// K >= 1, C >= 1. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int npf_setconv_fwd(const float* keys, const float* queries, const float* values,
                               const float* mask, const float* sigma, int B, int K, int Q, int C,
                               int p, float* out_sig, float* out_den, void* stream) {
  if (K < 1 || C < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= kNarrowC) {
    setconv_fwd_narrow<<<dim3((Q + kNQ - 1) / kNQ, B), kNThreads, 0, s>>>(
        keys, queries, values, mask, sigma, K, Q, C, p, out_sig, out_den);
  } else {
    int dev = 0, n_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const int c_tiles = (C + kTC - 1) / kTC;
    if ((long long)((Q + 63) / 64) * B * c_tiles >= (long long)kMinBlocksPerSm * n_sm)
      setconv_fwd_wide<8><<<dim3((Q + 63) / 64, B, c_tiles), kThreads, 0, s>>>(
          keys, queries, values, mask, sigma, K, Q, C, p, out_sig, out_den);
    else
      setconv_fwd_wide<4><<<dim3((Q + 31) / 32, B, c_tiles), kThreads, 0, s>>>(
          keys, queries, values, mask, sigma, K, Q, C, p, out_sig, out_den);
  }
  return (int)cudaGetLastError();
}
