// Fused ReLU MLP chain forward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py::_fwd_kernel
//   (launcher _fwd_impl, entry fused_relu_mlp).
//
// For each row of x [M, C]:
//   a = relu(x @ w0^T + b0)
//   repeat L1 times: r = relu(a @ wh[l]^T + bh[l]); a = is_res ? r + a : r
//   out = a @ wout^T + bout
// Weights use PyTorch's Linear layout [out, in]; every bias may be null.
//
// What bounds it on the H100: at the decoder shape of the flagship path
// (M = 65,536, C = H = 128, L1 = 3, O = 2) the chain is about 8.6 GFLOP of f32
// FMA against 34 MB of input and output, so it is bound by f32 operations, and
// every activation written between layers would be another 34 MB of traffic.
//
// Design: one block per tile of 64 rows (fewer when the widths need more
// shared memory). The tile's activations stay in shared memory across every
// layer, so only x is read and only out is written. Five 128 x 128 f32 weight
// matrices (320 KB) do not fit the 227 KB a block may use, which the TPU
// kernel's "all weights resident in VMEM" relied on; here each layer's weights
// stream through shared memory in chunks of 32 input features x 128 output
// features, read once per block from L2. Each thread computes a RM x 8
// register tile of the layer's output with f32 FMA and f32 accumulation;
// neighbouring threads own neighbouring output columns, so the shared-memory
// reads of one warp hit distinct banks. Any C, H, O and L1 >= 0 are accepted
// up to the shared-memory limit. Tensor cores are left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kTN = 128;               // output columns per pass: 16 threads x 8
constexpr int kTKc = 32;               // input features per weight chunk
constexpr int kWsStride = kTN + 1;     // +1: the transposed store hits distinct banks
constexpr int kMaxSmem = 232448;       // per-block shared memory on sm_90

template <int RM>
__device__ __forceinline__ void dense_layer(const float* a_in, int lda, int kd,
                                            const float* __restrict__ w,
                                            const float* __restrict__ bias, int n_out,
                                            bool relu, bool res, float* a_out, float* out_g,
                                            int row0, int M, float* ws) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int n0 = 0; n0 < n_out; n0 += kTN) {
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < kd; k0 += kTKc) {
      const int nk = min(kTKc, kd - k0);
      // stage w[n0 : n0+128, k0 : k0+32] transposed: ws[kk][n]
      for (int e = tid; e < kTN * kTKc; e += kThreads) {
        const int n = e / kTKc;
        const int kk = e - n * kTKc;
        float v = 0.f;
        if (n0 + n < n_out && kk < nk) v = w[(size_t)(n0 + n) * kd + k0 + kk];
        ws[kk * kWsStride + n] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        float a[RM], b[8];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = a_in[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[kk * kWsStride + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= n_out) continue;
        float v = acc[i][j] + (bias ? bias[n] : 0.f);
        if (relu) v = fmaxf(v, 0.f);
        if (res) v += a_in[r * lda + n];
        if (a_out) {
          a_out[r * lda + n] = v;
        } else if (row0 + r < M) {
          out_g[(size_t)(row0 + r) * n_out + n] = v;
        }
      }
    }
  }
  __syncthreads();  // a_out is complete before the next layer reads it
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
mlp_chain_fwd_kernel(const float* __restrict__ x, int M, int C, const float* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ wh,
                     const float* __restrict__ bh, int L1, int H,
                     const float* __restrict__ wout, const float* __restrict__ bout, int O,
                     int is_res, float* __restrict__ out) {
  constexpr int TM = 16 * RM;
  extern __shared__ float smem[];
  const int lda = max(C, H) + 1;  // +1: the two row groups of a warp hit distinct banks
  float* a0 = smem;
  float* a1 = a0 + TM * lda;
  float* ws = a1 + TM * lda;
  const int row0 = blockIdx.x * TM;

  for (int e = threadIdx.x; e < TM * C; e += kThreads) {
    const int r = e / C;
    const int c = e - r * C;
    a0[r * lda + c] = row0 + r < M ? x[(size_t)(row0 + r) * C + c] : 0.f;
  }
  __syncthreads();

  dense_layer<RM>(a0, lda, C, w0, b0, H, true, false, a1, nullptr, row0, M, ws);
  float* cur = a1;
  float* nxt = a0;
  for (int l = 0; l < L1; ++l) {
    dense_layer<RM>(cur, lda, H, wh + (size_t)l * H * H, bh ? bh + (size_t)l * H : nullptr, H,
                    true, is_res != 0, nxt, nullptr, row0, M, ws);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  dense_layer<RM>(cur, lda, H, wout, bout, O, false, false, nullptr, out, row0, M, ws);
}

size_t smem_bytes(int rm, int C, int H) {
  const int lda = (C > H ? C : H) + 1;
  return (size_t)(2 * 16 * rm * lda + kTKc * kWsStride) * sizeof(float);
}

template <int RM>
int launch(const float* x, int M, int C, const float* w0, const float* b0, const float* wh,
           const float* bh, int L1, int H, const float* wout, const float* bout, int O,
           int is_res, float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes(RM, C, H);
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_fwd_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tm = 16 * RM;
  mlp_chain_fwd_kernel<RM><<<(M + tm - 1) / tm, kThreads, smem, stream>>>(
      x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [M,C], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O] -> out [M,O];
// float32, contiguous, on the current device; any bias pointer may be null.
// The row tile is the largest of 64, 32, 16 rows whose activations fit in
// shared memory. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int npf_mlp_chain_fwd(const float* x, int M, int C, const float* w0, const float* b0,
                                 const float* wh, const float* bh, int L1, int H,
                                 const float* wout, const float* bout, int O, int is_res,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (smem_bytes(4, C, H) <= kMaxSmem)
    return launch<4>(x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, s);
  if (smem_bytes(2, C, H) <= kMaxSmem)
    return launch<2>(x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, s);
  if (smem_bytes(1, C, H) <= kMaxSmem)
    return launch<1>(x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, s);
  return (int)cudaErrorInvalidValue;
}
