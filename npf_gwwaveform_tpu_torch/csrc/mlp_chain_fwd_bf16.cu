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
// each product summed in f32 (the rounding points and the order of the
// sums: mlp_chain_bf16.cuh). Weights use PyTorch's Linear layout [out, in];
// every bias may be null.
//
// What bounds it on the H100: at the scoring shape (M = 65,536, C = H = 128,
// L1 = 3, O = 2) the chain is 8.6 GFLOP, 8.7 us at the bf16 tensor cores'
// 989 TFLOP/s, against 17 MB of bf16 x and out (5.2 us at 3.35 TB/s): bound
// by operations. So the products run on the tensor cores, as the Pallas
// kernel's run on the TPU's matrix unit (bf16 operands, f32 accumulation).
//
// Design (tensor-core path, C, H, O <= 128 with every weight in one block's
// shared memory; csrc/mlp_chain_bf16_plan.h): a persistent grid of at most
// one block of kFwdTcWarps (16) warps a SM. A block stages every weight and
// bias of the chain into shared memory once, rounded to bf16 (the decoder's
// 65.8 K weights: 144 KB with the row skew), so the weights cross from L2
// once a SM, not once a row tile; each pair of warps' first rows load
// meanwhile. Then each pair of warps walks its own 16-row tiles (tile pair *
// grid + block, ...): both warps read the layer's input rows from the pair's
// row buffer as ldmatrix A fragments, each computes half the output columns
// with mma.sync m16n8k16 against ldmatrix'd weight fragments, `settle`
// (mlp_chain_bf16.cuh) adds the bias and sums again in the plain version's
// order the few outputs whose rounding the tensor cores' sum leaves
// undecided, and the epilogue (ReLU, bf16 rounding, residual) writes the
// warp's half of the next layer's input into the pair's other row buffer;
// one pair barrier a layer. Splitting a tile's columns over two warps halves
// each warp's work a layer, and the tile's layers run one after another, so
// it shortens each tile where tiles are few: at the training shape (M =
// 8,192: 512 tiles) the grid is 128 blocks of four busy pairs. The O outputs
// are an n8 product with zero-padded weight rows.
//
// Wider chains (C, H or O over 128, or weights past the shared memory) take
// an f32-FMA kernel (one block of 256 threads per tile of 64 or 32 rows,
// activations transposed in shared memory, weights streamed in chunks,
// csrc/mlp_chain_bf16_fma.cuh), which sums in the plain version's order;
// widths whose two activation buffers exceed the shared memory (max(C, H)
// over 748) are refused before any launch. The plan, asked through
// npf_mlp_chain_fwd_bf16_path, chooses.

#include <algorithm>

#include "mlp_chain_bf16_fma.cuh"

namespace {

using namespace npf_bf16;

constexpr int kSmallO = 16;   // FMA path, O <= kSmallO: per-(row, output) dot products
constexpr int kMinBusyPairs = 4;  // tensor-core path: fewer blocks rather than idler warps

__global__ void __launch_bounds__(kFwdTcWarps * 32, 1)
mlp_chain_fwd_bf16_tc(const __nv_bfloat16* __restrict__ x, int M, int C,
                      const float* __restrict__ w0, const float* __restrict__ b0,
                      const float* __restrict__ wh, const float* __restrict__ bh, int L1, int H,
                      const float* __restrict__ wout, const float* __restrict__ bout, int O,
                      int is_res, __nv_bfloat16* __restrict__ out, TcLayout L) {
  extern __shared__ __align__(16) float smem_f[];  // one declaration a file: the FMA kernel's
  auto* smem = reinterpret_cast<unsigned char*>(smem_f);
  auto* w0s = reinterpret_cast<__nv_bfloat16*>(smem + L.w0);
  auto* whs = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  auto* wos = reinterpret_cast<__nv_bfloat16*>(smem + L.wo);
  auto* b0s = reinterpret_cast<float*>(smem + L.b0);
  auto* bhs = reinterpret_cast<float*>(smem + L.bh);
  auto* bos = reinterpret_cast<float*>(smem + L.bo);
  const int ldc = L.cp + kSkew, ldh = L.hp + kSkew;
  const int warp = threadIdx.x >> 5, pair = warp >> 1;
  const int lane = threadIdx.x & 31;
  const int ldr = L.kp + kSkew;
  // the pair's two row buffers: buf(0), buf(1)
  __nv_bfloat16* const bufs =
      reinterpret_cast<__nv_bfloat16*>(smem + L.buf) + 2 * pair * 16 * ldr;
  auto buf = [=](int i) { return bufs + i * 16 * ldr; };
  const bool xvec = (C & 1) == 0 && ((uintptr_t)x & 3) == 0;
  // the first tile's rows are in flight while the weights are staged
  const int first = pair * gridDim.x + blockIdx.x;
  uint32_t rv[kShareKT][4];
  fetch_rows(rv, x, C, xvec, first * 16, M);
  stage_weight(w0s, ldc, w0, H, C, L.hp, L.cp);
  for (int l = 0; l < L1; ++l)
    stage_weight(whs + (size_t)l * L.hp * ldh, ldh, wh + (size_t)l * H * H, H, H, L.hp, L.hp);
  stage_weight(wos, ldh, wout, O, H, L.op, L.hp);
  stage_bias(b0s, b0, H, L.hp);
  for (int l = 0; l < L1; ++l)
    stage_bias(bhs + (size_t)l * L.hp, bh ? bh + (size_t)l * H : nullptr, H, L.hp);
  stage_bias(bos, bout, O, L.op);
  auto* wmax = reinterpret_cast<float*>(smem + L.wmax);  // [L1 + 2][2]
  for (int i = threadIdx.x; i < 2 * (L1 + 2); i += blockDim.x) wmax[i] = 0.f;
  put_rows(buf(0), ldr, C, rv);
  __syncthreads();
  stage_norm_max(wmax, w0s, ldc, L.hp, L.cp, false);
  for (int l = 0; l < L1; ++l)
    stage_norm_max(wmax + 2 * (l + 1), whs + (size_t)l * L.hp * ldh, ldh, L.hp, L.hp, false);
  stage_norm_max(wmax + 2 * (L1 + 1), wos, ldh, L.op, L.hp, false);
  __syncthreads();

  const FixList fix(smem + L.fix, L.warps, L.fixcap, warp);
  int j0, nt, jo, nto;  // this warp's share of the hidden and of the output columns
  share(L.hp / 16, j0, nt);
  share(L.op / 16, jo, nto);
  const int kt = L.hp / 16, kt0 = L.cp / 16;
  const bool res = is_res != 0;
  const bool ovec = (O & 1) == 0 && ((uintptr_t)out & 3) == 0;
  const int n_tiles = (M + 15) / 16;
  float acc[kHalfNT][4];
  float n0, n1;
  const int stride = kFwdTcWarps / 2 * gridDim.x;  // pairs of the grid
  for (int tile = first; tile < n_tiles; tile += stride) {
    const int row0 = tile * 16;
    if (tile != first) {  // the first tile's rows are in
      pair_sync();  // the pair is done with the last tile's buffers
      fetch_rows(rv, x, C, xvec, row0, M);
      put_rows(buf(0), ldr, C, rv);
      pair_sync();
    }
    // to_hidden, the hidden layers (l = 0 .. L1 - 1), then the output layer
    int cur = 0;
    for (int l = -1; l < L1; ++l) {
      const bool first_layer = l < 0;
      const __nv_bfloat16* w = first_layer ? w0s : whs + (size_t)l * L.hp * ldh;
      const int ld = first_layer ? ldc : ldh;
      const float wm = kFixEps * wmax[2 * (l + 1)];
      product<false>(acc, buf(cur), ldr, first_layer ? kt0 : kt, w, ld, j0, nt, n0, n1);
      settle<false, true>(acc, nt, j0, H, first_layer ? b0s : bhs + (size_t)l * L.hp, wm * n0,
                          wm * n1, buf(cur), ldr, w, ld, first_layer ? L.cp : L.hp, fix);
      epi_hidden(acc, nt, j0, res && !first_layer, buf(cur), buf(1 - cur), ldr, nullptr, 0, row0,
                 M);
      pair_sync();
      cur = 1 - cur;
    }
    const float wm = kFixEps * wmax[2 * (L1 + 1)];
    product<false>(acc, buf(cur), ldr, kt, wos, ldh, jo, nto, n0, n1);
    settle<false, false>(acc, nto, jo, O, bos, wm * n0, wm * n1, buf(cur), ldr, wos, ldh, L.hp,
                         fix);
    const int r = row0 + (lane >> 2), c = 2 * (lane & 3) + 8 * jo;
#pragma unroll
    for (int j = 0; j < kHalfNT; ++j) {
      if (j >= nto) break;
      store_pair(out, O, ovec, r, j * 8 + c, M, O, pack(acc[j][0], acc[j][1]));
      store_pair(out, O, ovec, r + 8, j * 8 + c, M, O, pack(acc[j][2], acc[j][3]));
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
mlp_chain_fwd_bf16_fma(const __nv_bfloat16* __restrict__ x, int M, int C,
                       const float* __restrict__ w0, const float* __restrict__ b0,
                       const float* __restrict__ wh, const float* __restrict__ bh, int L1, int H,
                       const float* __restrict__ wout, const float* __restrict__ bout, int O,
                       int is_res, __nv_bfloat16* __restrict__ out, int kpad) {
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
cudaError_t launch_fma(size_t smem, cudaStream_t s, const __nv_bfloat16* x, int M, int C,
                       const float* w0, const float* b0, const float* wh, const float* bh, int L1,
                       int H, const float* wout, const float* bout, int O, int is_res,
                       __nv_bfloat16* out, int kpad) {
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_fwd_bf16_fma<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (M + Rows<RM>::TM - 1) / Rows<RM>::TM;
  mlp_chain_fwd_bf16_fma<RM><<<blocks, kThreads, smem, s>>>(x, M, C, w0, b0, wh, bh, L1, H, wout,
                                                            bout, O, is_res, out, kpad);
  return cudaGetLastError();
}

}  // namespace

// x [M,C] bf16, w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O]
// float32 -> out [M,O] bf16; contiguous, on the current device; any bias
// pointer may be null. Launches one kernel on `stream` (the plan's path:
// csrc/mlp_chain_bf16_plan.cu), allocates nothing, does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int npf_mlp_chain_fwd_bf16(const void* x, int M, int C, const float* w0,
                                      const float* b0, const float* wh, const float* bh, int L1,
                                      int H, const float* wout, const float* bout, int O,
                                      int is_res, void* out, void* stream) {
  const FwdPlan p = fwd_plan(M, C, H, L1, O);
  if (p.path == kPathRefused || M < 1) return (int)cudaErrorInvalidValue;
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.path == kPathFma) {
    const int kpad = std::max(C, H);
    return (int)(p.rm == 8 ? launch_fma<8>(p.smem, s, xb, M, C, w0, b0, wh, bh, L1, H, wout, bout,
                                           O, is_res, ob, kpad)
                           : launch_fma<4>(p.smem, s, xb, M, C, w0, b0, wh, bh, L1, H, wout, bout,
                                           O, is_res, ob, kpad));
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlp_chain_fwd_bf16_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + 15) / 16;
  const int blocks = std::max(1, std::min(sms, (tiles + kMinBusyPairs - 1) / kMinBusyPairs));
  mlp_chain_fwd_bf16_tc<<<blocks, kFwdTcWarps * 32, p.smem, s>>>(xb, M, C, w0, b0, wh, bh, L1,
                                                                  H, wout, bout, O, is_res, ob,
                                                                  p.tc);
  return (int)cudaGetLastError();
}
