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
// What bounds it on the H100: at the grid->target shape of the flagship path
// (B=256, K=384, Q=256, C=128) the weighted sum is 2*C flop per (q, k) pair,
// about 6.4 GFLOP of f32 FMA against 58 MB of inputs and outputs, so it is
// bound by f32 operations; at the context->grid shape (C=1) the exps dominate
// and the output writes are small.
//
// Design: one block per (batch row, tile of 32 queries). Keys, mask and
// values stream through shared memory in chunks of 64 keys, so any K is
// accepted and nothing of size Q*K is ever stored. Each warp owns 4 queries
// and keeps, per query, a running max, a running softmax denominator and a
// running raw density in registers (online softmax, rescaled by
// exp(m_old - m_new) per chunk). The 32 x C signal accumulator lives in
// shared memory and is updated once per chunk by all 256 threads, neighbouring
// threads on neighbouring channels. This keeps the first version simple: the
// accumulation is plain f32 FMA fed from shared memory; tensor cores are
// left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTQ = 32;                   // queries per block
constexpr int kTK = 64;                   // keys per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQPerWarp = kTQ / kWarps;   // 4
constexpr int kKPerLane = kTK / 32;       // 2
constexpr float kNeg = -1e30f;            // the masked logit of the Pallas kernel
constexpr int kMaxSmem = 232448;          // per-block shared memory on sm_90

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
setconv_fwd_kernel(const float* __restrict__ keys, const float* __restrict__ queries,
                   const float* __restrict__ values, const float* __restrict__ mask,
                   const float* __restrict__ sigma_ptr, int K, int Q, int C, int p,
                   float* __restrict__ out_sig, float* __restrict__ out_den) {
  extern __shared__ float dyn[];
  float* v_s = dyn;               // [kTK][C] values of the current key chunk
  float* acc_s = dyn + kTK * C;   // [kTQ][C] unnormalised signal
  __shared__ float k_s[kTK];
  __shared__ float m_s[kTK];
  __shared__ float p_s[kTQ][kTK + 1];   // +1: lanes of one query row hit distinct banks
  __shared__ float scale_s[kTQ];
  __shared__ float l_s[kTQ];

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kTQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sigma = *sigma_ptr;
  const float* keys_b = keys + (size_t)b * K;
  const float* mask_b = mask + (size_t)b * K;
  const float* values_b = values + (size_t)b * K * C;

  float qv[kQPerWarp], m_run[kQPerWarp], l_run[kQPerWarp], d_run[kQPerWarp];
#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int qg = q0 + warp + kWarps * i;
    qv[i] = qg < Q ? queries[(size_t)b * Q + qg] : 0.f;
    m_run[i] = kNeg;
    l_run[i] = 0.f;
    d_run[i] = 0.f;
  }
  for (int e = tid; e < kTQ * C; e += kThreads) acc_s[e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kTK) {
    const int nk = min(kTK, K - k0);
    __syncthreads();  // the previous chunk's readers are done
    if (tid < kTK) {
      k_s[tid] = tid < nk ? keys_b[k0 + tid] : 0.f;
      m_s[tid] = tid < nk ? mask_b[k0 + tid] : 0.f;  // keys past K count as masked
    }
    const float* v_src = values_b + (size_t)k0 * C;
    for (int e = tid; e < kTK * C; e += kThreads) v_s[e] = e < nk * C ? v_src[e] : 0.f;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kQPerWarp; ++i) {
      const int ql = warp + kWarps * i;
      float lg[kKPerLane];
      bool on[kKPerLane];
      float cmax = kNeg, dsum = 0.f;
#pragma unroll
      for (int t = 0; t < kKPerLane; ++t) {
        const int kk = lane + 32 * t;
        on[t] = m_s[kk] > 0.5f;
        const float u = fabsf(k_s[kk] - qv[i]) / sigma;
        const float inp = p == 2 ? -(u * u) : -powf(u, (float)p);
        if (on[t]) dsum += expf(inp);
        lg[t] = on[t] ? inp : kNeg;
        cmax = fmaxf(cmax, lg[t]);
      }
      cmax = warp_max(cmax);
      dsum = warp_sum(dsum);
      const float m_new = fmaxf(m_run[i], cmax);
      float psum = 0.f;
#pragma unroll
      for (int t = 0; t < kKPerLane; ++t) {
        const float pe = on[t] ? expf(lg[t] - m_new) : 0.f;
        p_s[ql][lane + 32 * t] = pe;
        psum += pe;
      }
      psum = warp_sum(psum);
      const float scale = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * scale + psum;
      d_run[i] += dsum;
      m_run[i] = m_new;
      if (lane == 0) scale_s[ql] = scale;
    }
    __syncthreads();

    for (int e = tid; e < kTQ * C; e += kThreads) {
      const int ql = e / C;
      const int c = e - ql * C;
      const float* pr = p_s[ql];
      float a = acc_s[e] * scale_s[ql];
#pragma unroll 8
      for (int kk = 0; kk < kTK; ++kk) a = fmaf(pr[kk], v_s[kk * C + c], a);
      acc_s[e] = a;
    }
  }

#pragma unroll
  for (int i = 0; i < kQPerWarp; ++i) {
    const int ql = warp + kWarps * i;
    const int qg = q0 + ql;
    if (lane == 0) {
      l_s[ql] = l_run[i];
      if (qg < Q) out_den[(size_t)b * Q + qg] = d_run[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < kTQ * C; e += kThreads) {
    const int ql = e / C;
    const int qg = q0 + ql;
    if (qg < Q) out_sig[((size_t)b * Q + qg) * C + (e - ql * C)] = acc_s[e] / fmaxf(l_s[ql], 1e-30f);
  }
}

}  // namespace

// keys [B,K], queries [B,Q], values [B,K,C], mask [B,K] (1.0 = real key), sigma [1],
// all float32, contiguous, on the current device -> out_sig [B,Q,C], out_den [B,Q].
// Launches on `stream`, allocates nothing, does not synchronise. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int npf_setconv_fwd(const float* keys, const float* queries, const float* values,
                               const float* mask, const float* sigma, int B, int K, int Q, int C,
                               int p, float* out_sig, float* out_den, void* stream) {
  const size_t smem = (size_t)(kTK + kTQ) * C * sizeof(float);
  if (smem > (size_t)kMaxSmem - 16384) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(setconv_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kTQ - 1) / kTQ, B);
  setconv_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      keys, queries, values, mask, sigma, K, Q, C, p, out_sig, out_den);
  return (int)cudaGetLastError();
}
