// Fused ReLU MLP chain forward in bfloat16 compute, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py::_fwd_kernel
//   at compute_dtype=bfloat16 (launcher _fwd_impl, entry fused_relu_mlp).
//
// For each row of x [M, C] (bf16), with every weight and bias rounded to bf16
// (they arrive as the model's f32 parameters):
//   a = bf16(relu(x @ w0^T + b0))
//   repeat L1 times: r = bf16(relu(a @ wh[l]^T + bh[l])); a = is_res ? bf16(r + a) : r
//   out = bf16(a @ wout^T + bout)
// each product summed in f32 (the rounding points: mlp_chain_bf16.cuh).
// Weights use PyTorch's Linear layout [out, in]; every bias may be null.
//
// What bounds it on the H100: at the scoring shape (M = 65,536, C = H = 128,
// L1 = 3, O = 2) the chain is 8.6 GFLOP, 8.7 us at the bf16 tensor cores'
// 989 TFLOP/s, against 17 MB of bf16 x and out (5.2 us at 3.35 TB/s): bound
// by operations. This first bf16 kernel does not reach for that bound: it
// sums on the f32 FMA pipe (67 TFLOP/s, 0.13 ms for the same work) so that
// each sum runs in the plain version's order and the two agree bit for bit
// (mlp_chain_bf16.cuh). mma.sync or wgmma at f32 accumulation would sum the
// same exact products in the tensor core's order; that is the next step.
//
// Design: one block of 256 threads per tile of TM rows (64, or 32 when
// fewer than two tiles a SM would fill the card or the widths need the
// room). The tile's activations never leave shared memory: x is staged
// transposed, and each layer's epilogue (bias, ReLU, residual, rounding)
// writes the next layer's operand into the other of two buffers. For
// O <= kSmallO (the decoder's O = 2) each (row, output) pair is one
// thread's dot product over the features, in order; wider outputs take the
// tiled product. Every sum runs in a fixed order, so two launches on the same
// inputs give the same bits. Widths whose two buffers exceed the shared
// memory (max(C, H) over 748) are refused before any launch.

#include <algorithm>

#include "mlp_chain_bf16.cuh"

namespace {

using namespace npf_bf16;

constexpr int kSmallO = 16;  // O <= kSmallO: the output layer is per-(row, output) dot products

size_t fwd_smem(int rm, int kpad) {
  return 2 * (size_t)kpad * (8 * rm + 4) * sizeof(float) + kStageBytes;
}

int kpad_of(int C, int H) { return std::max(C, H); }

// 64-row tiles when they fit and at least two a SM fill the card, else 32; 0: too wide
int choose_rm(int M, int C, int H) {
  const int kpad = kpad_of(C, H);
  if (fwd_smem(8, kpad) <= (size_t)kMaxSmem && (M + 63) / 64 >= 2 * 132) return 8;
  return fwd_smem(4, kpad) <= (size_t)kMaxSmem ? 4 : 0;
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
mlp_chain_fwd_bf16(const __nv_bfloat16* __restrict__ x, int M, int C, const float* __restrict__ w0,
                   const float* __restrict__ b0, const float* __restrict__ wh,
                   const float* __restrict__ bh, int L1, int H, const float* __restrict__ wout,
                   const float* __restrict__ bout, int O, int is_res,
                   __nv_bfloat16* __restrict__ out, int kpad) {
  constexpr int TM = Rows<RM>::TM;
  constexpr int LDA = Rows<RM>::LDA;
  extern __shared__ __align__(16) float smem[];
  float* buf[2] = {smem, smem + (size_t)kpad * LDA};
  float* bs = buf[1] + (size_t)kpad * LDA;
  const int row0 = blockIdx.x * TM;
  stage_rows<RM>(buf[0], x, row0, M, C);

  // a hidden layer's epilogue into `dst`: bias and ReLU in f32, rounded;
  // the residual added to the layer's input `src` and rounded again
  auto hidden = [](const float* bias, const float* src, float* dst, bool res) {
    return [=](int r, int n, float h) {
      if (bias) h += bfr(__ldg(bias + n));
      float a = bfr(fmaxf(h, 0.f));
      if (res) a = bfr(a + src[n * LDA + r]);
      dst[n * LDA + r] = a;
    };
  };
  product<RM, true>(buf[0], w0, C, H, bs, hidden(b0, buf[0], buf[1], false));
  int cur = 1;
  for (int l = 0; l < L1; ++l) {
    product<RM, true>(buf[cur], wh + (size_t)l * H * H, H, H, bs,
                      hidden(bh ? bh + (size_t)l * H : nullptr, buf[cur], buf[1 - cur],
                             is_res != 0));
    cur = 1 - cur;
  }
  const float* a = buf[cur];

  if (O > kSmallO) {
    product<RM, true>(a, wout, H, O, bs, [=](int r, int n, float h) {
      if (bout) h += bfr(__ldg(bout + n));
      if (row0 + r < M) out[(size_t)(row0 + r) * O + n] = __float2bfloat16_rn(h);
    });
    return;
  }
  __syncthreads();  // the last activations are visible
  for (int p = threadIdx.x; p < TM * O; p += kThreads) {
    const int r = p % TM;
    const int o = p / TM;
    if (row0 + r >= M) continue;
    const float* wo = wout + (size_t)o * H;
    float h = 0.f;
    for (int k = 0; k < H; ++k) h = fmaf(a[k * LDA + r], bfr(__ldg(wo + k)), h);
    if (bout) h += bfr(__ldg(bout + o));
    out[(size_t)(row0 + r) * O + o] = __float2bfloat16_rn(h);
  }
}

template <int RM>
cudaError_t launch(size_t smem, cudaStream_t s, const __nv_bfloat16* x, int M, int C,
                   const float* w0, const float* b0, const float* wh, const float* bh, int L1,
                   int H, const float* wout, const float* bout, int O, int is_res,
                   __nv_bfloat16* out, int kpad) {
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_fwd_bf16<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + Rows<RM>::TM - 1) / Rows<RM>::TM;
  mlp_chain_fwd_bf16<RM><<<blocks, kThreads, smem, s>>>(x, M, C, w0, b0, wh, bh, L1, H, wout,
                                                        bout, O, is_res, out, kpad);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block of the launch takes; -1 when the widths
// exceed what a block can hold (nothing may be launched then).
extern "C" long long npf_mlp_chain_fwd_bf16_smem(int M, int C, int H, int O) {
  (void)O;  // the output layer needs no shared memory of its own
  const int rm = choose_rm(M, C, H);
  return rm == 0 ? -1 : (long long)fwd_smem(rm, kpad_of(C, H));
}

// x [M,C] bf16, w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O]
// float32 -> out [M,O] bf16; contiguous, on the current device; any bias
// pointer may be null. Launches one kernel on `stream`, allocates nothing,
// does not synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int npf_mlp_chain_fwd_bf16(const void* x, int M, int C, const float* w0,
                                      const float* b0, const float* wh, const float* bh, int L1,
                                      int H, const float* wout, const float* bout, int O,
                                      int is_res, void* out, void* stream) {
  const int rm = choose_rm(M, C, H);
  if (rm == 0 || M < 1) return (int)cudaErrorInvalidValue;
  const int kpad = kpad_of(C, H);
  const size_t smem = fwd_smem(rm, kpad);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(rm == 8 ? launch<8>(smem, s, xb, M, C, w0, b0, wh, bh, L1, H, wout, bout, O,
                                   is_res, ob, kpad)
                       : launch<4>(smem, s, xb, M, C, w0, b0, wh, bh, L1, H, wout, bout, O,
                                   is_res, ob, kpad));
}
