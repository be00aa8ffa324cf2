// Fused ReLU MLP chain backward, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py::_bwd_kernel
//   (launcher _bwd_impl, the custom_vjp backward of fused_relu_mlp).
//
// Forward (as csrc/mlp_chain_fwd.cu), for each row of x [M, C]:
//   a_0 = relu(x @ w0^T + b0)
//   a_{l+1} = relu(a_l @ wh[l]^T + bh[l]) (+ a_l when is_res), l < L1
//   out = a_L1 @ wout^T + bout
// Given g = d loss / d out [M, O], this computes dx [M, C] and the row sums
// dw0 [H, C], db0 [H], dwh [L1, H, H], dbh [L1, H], dwout [O, H], dbout [O],
// in f32, in PyTorch's Linear layout [out, in]. Any bias pointer may be null
// (it is zero in the recompute; its gradient is computed all the same).
//
// What bounds it on the H100: at the training shape (M = 8,192, C = H = 128,
// L1 = 3, O = 2) the forward recompute is ~1.08 GFLOP and the backward (the
// input gradient and the weight gradient of each layer) ~2.16 GFLOP, against
// ~8.5 MB of x, g, dx and weights: bound by f32 operations (~0.05 ms at
// 67 TFLOP/s), not by bytes (~2.5 us at 3.35 TB/s).
//
// Design. The TPU kernel walks its row tiles in order on one core and adds
// every tile's dW/db into output blocks that stay put across the grid; CUDA
// blocks run concurrently in no order. So each block here walks a fixed
// stride of row tiles (tile b, b + G, b + 2G, ... for block b of G) and adds
// its tiles' dW/db into its own slice of a global scratch buffer that the
// wrapper allocates (no other block touches it: no atomics); a second
// launch sums the G slices in block order. Every sum runs in a fixed order,
// so two launches on the same inputs give the same bits.
//
// Per row tile (TM = 16 * RM rows; 32 at the flagship widths) the block
// recomputes the chain in shared memory, keeping each layer's input and its
// ReLU mask as bytes (with is_res the mask cannot be read back from a_{l+1}),
// then walks the layers backwards:
//   gpre = g * mask_l;  dW_l += gpre^T a_l;  db_l += sum_rows gpre;
//   g = gpre @ W_l (+ g when the layer is residual).
// The products run as in the forward kernel: weights stream through shared
// memory in 32 x 128 chunks, each thread owns an RM x 8 register tile of the
// output with f32 FMA; the weight gradient owns an 8 x 8 tile of dW and
// reduces over the tile's rows from shared memory. Rows past M are zero in
// x and g, so they add exact zeros. Tensor cores are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kTN = 128;            // output columns per pass: 16 threads x 8
constexpr int kTKc = 32;            // reduction depth per weight chunk
constexpr int kWsStride = kTN + 1;
constexpr int kMaxSmem = 232448;    // per-block shared memory on sm_90
constexpr int kMaxBlocks = 128;     // G: blocks (and scratch slices) at most

// out[r, n] = sum_k a[r, k] * W(n, k) for the tile's rows r < 16 * RM and
// n < n_out, handed to epi(r, n, value). W(n, k) is w[n * kd + k] (a Linear
// weight [n_out, kd]) or, with w_trans, w[k * n_out + n] (a weight [kd, n_out]
// used transposed: the input gradient of a layer).
template <int RM, typename Epi>
__device__ __forceinline__ void tile_gemm(const float* a_in, int lda, int kd,
                                          const float* __restrict__ w, bool w_trans, int n_out,
                                          float* ws, Epi epi) {
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
      if (!w_trans) {  // ws[kk][n] = w[n0 + n, k0 + kk]
        for (int e = tid; e < kTN * kTKc; e += kThreads) {
          const int n = e / kTKc;
          const int kk = e - n * kTKc;
          float v = 0.f;
          if (n0 + n < n_out && kk < nk) v = w[(size_t)(n0 + n) * kd + k0 + kk];
          ws[kk * kWsStride + n] = v;
        }
      } else {  // ws[kk][n] = w[k0 + kk, n0 + n]
        for (int e = tid; e < kTN * kTKc; e += kThreads) {
          const int kk = e / kTN;
          const int n = e - kk * kTN;
          float v = 0.f;
          if (n0 + n < n_out && kk < nk) v = w[(size_t)(k0 + kk) * n_out + n0 + n];
          ws[kk * kWsStride + n] = v;
        }
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
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < n_out) epi(ty + 16 * i, n, acc[i][j]);
      }
  }
  __syncthreads();  // the epilogue's writes are complete before anyone reads them
}

// part[n * kd + k] (+)= sum_{r < tm} gp[r, n] * a[r, k] and
// part_b[n] (+)= sum_r gp[r, n]: one layer's weight and bias gradient over
// the tile's rows, added to this block's scratch slice (`first`: stored).
// Reads shared memory only; each output element belongs to one thread.
__device__ __forceinline__ void tile_wgrad(const float* gp, int n_out, const float* a, int kd,
                                           int ld, int tm, float* __restrict__ part,
                                           float* __restrict__ part_b, bool first) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int n0 = 0; n0 < n_out; n0 += kTN) {
    for (int k0 = 0; k0 < kd; k0 += kTN) {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < tm; ++r) {
        float gv[8], av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = n0 + ty + 16 * i;
          gv[i] = n < n_out ? gp[r * ld + n] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          av[j] = k < kd ? a[r * ld + k] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(gv[i], av[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + ty + 16 * i;
        if (n >= n_out) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + tx + 16 * j;
          if (k >= kd) continue;
          const size_t idx = (size_t)n * kd + k;
          part[idx] = first ? acc[i][j] : part[idx] + acc[i][j];
        }
      }
    }
  }
  for (int n = tid; n < n_out; n += kThreads) {
    float s = 0.f;
    for (int r = 0; r < tm; ++r) s += gp[r * ld + n];
    part_b[n] = first ? s : part_b[n] + s;
  }
}

// gp[r, n] = g[r, n] where the layer's pre-activation was > 0, else 0
__device__ __forceinline__ void apply_mask(const float* g, const uint8_t* mask, int n_out,
                                           int ld, int tm, float* gp) {
  for (int e = threadIdx.x; e < tm * n_out; e += kThreads) {
    const int r = e / n_out;
    const int n = e - r * n_out;
    gp[r * ld + n] = mask[e] ? g[r * ld + n] : 0.f;
  }
  __syncthreads();
}

struct Offsets {  // of each gradient in one scratch slice (and in the result)
  size_t dw0, db0, dwh, dbh, dwout, dbout, total;
};

__host__ __device__ inline Offsets offsets(int C, int H, int L1, int O) {
  Offsets o;
  o.dw0 = 0;
  o.db0 = o.dw0 + (size_t)H * C;
  o.dwh = o.db0 + H;
  o.dbh = o.dwh + (size_t)L1 * H * H;
  o.dwout = o.dbh + (size_t)L1 * H;
  o.dbout = o.dwout + (size_t)O * H;
  o.total = o.dbout + O;
  return o;
}

template <int RM>
__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, int M, int C,
                     const float* __restrict__ w0, const float* __restrict__ b0,
                     const float* __restrict__ wh, const float* __restrict__ bh, int L1, int H,
                     const float* __restrict__ wout, int O, int is_res,
                     float* __restrict__ dx, float* __restrict__ scratch) {
  constexpr int TM = 16 * RM;
  extern __shared__ float smem[];
  const int ld = max(max(C, H), O) + 1;  // +1: the two row groups of a warp hit distinct banks
  float* xs = smem;                       // [TM, ld] the tile of x
  float* acts = xs + TM * ld;             // L1 + 1 of [TM, ld]: a_0 .. a_L1
  float* g0 = acts + (L1 + 1) * TM * ld;  // [TM, ld] gradient of the current layer's output
  float* g1 = g0 + TM * ld;               // [TM, ld] masked gradient (and the tile of g)
  float* ws = g1 + TM * ld;               // [kTKc, kWsStride] weight chunk
  uint8_t* masks = reinterpret_cast<uint8_t*>(ws + kTKc * kWsStride);  // L1 + 1 of [TM, H]

  const Offsets off = offsets(C, H, L1, O);
  float* part = scratch + (size_t)blockIdx.x * off.total;
  const int n_tiles = (M + TM - 1) / TM;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, first = false) {
    const int row0 = tile * TM;
    for (int e = threadIdx.x; e < TM * C; e += kThreads) {
      const int r = e / C;
      const int c = e - r * C;
      xs[r * ld + c] = row0 + r < M ? x[(size_t)(row0 + r) * C + c] : 0.f;
    }
    for (int e = threadIdx.x; e < TM * O; e += kThreads) {
      const int r = e / O;
      const int o = e - r * O;
      g1[r * ld + o] = row0 + r < M ? g[(size_t)(row0 + r) * O + o] : 0.f;
    }
    __syncthreads();

    // forward recompute: a_0, then the hidden layers, keeping the masks
    tile_gemm<RM>(xs, ld, C, w0, false, H, ws, [&](int r, int n, float v) {
      v += b0 ? b0[n] : 0.f;
      const bool on = v > 0.f;
      masks[r * H + n] = on;
      acts[r * ld + n] = on ? v : 0.f;
    });
    for (int l = 0; l < L1; ++l) {
      const float* a_in = acts + l * TM * ld;
      float* a_out = acts + (l + 1) * TM * ld;
      uint8_t* m = masks + (l + 1) * TM * H;
      const float* bias = bh ? bh + (size_t)l * H : nullptr;
      tile_gemm<RM>(a_in, ld, H, wh + (size_t)l * H * H, false, H, ws,
                    [&](int r, int n, float v) {
                      v += bias ? bias[n] : 0.f;
                      const bool on = v > 0.f;
                      m[r * H + n] = on;
                      const float rv = on ? v : 0.f;
                      a_out[r * ld + n] = is_res ? rv + a_in[r * ld + n] : rv;
                    });
    }

    // output layer: dwout, dbout; g0 = g @ wout
    tile_wgrad(g1, O, acts + L1 * TM * ld, H, ld, TM, part + off.dwout, part + off.dbout, first);
    tile_gemm<RM>(g1, ld, O, wout, true, H, ws,
                  [&](int r, int n, float v) { g0[r * ld + n] = v; });

    // hidden layers, last first
    for (int l = L1 - 1; l >= 0; --l) {
      apply_mask(g0, masks + (l + 1) * TM * H, H, ld, TM, g1);
      tile_wgrad(g1, H, acts + l * TM * ld, H, ld, TM, part + off.dwh + (size_t)l * H * H,
                 part + off.dbh + (size_t)l * H, first);
      tile_gemm<RM>(g1, ld, H, wh + (size_t)l * H * H, true, H, ws, [&](int r, int n, float v) {
        g0[r * ld + n] = is_res ? v + g0[r * ld + n] : v;
      });
    }

    // first layer: dw0, db0, dx
    apply_mask(g0, masks, H, ld, TM, g1);
    tile_wgrad(g1, H, xs, C, ld, TM, part + off.dw0, part + off.db0, first);
    tile_gemm<RM>(g1, ld, H, w0, true, C, ws, [&](int r, int n, float v) {
      if (row0 + r < M) dx[(size_t)(row0 + r) * C + n] = v;
    });
  }
}

// out[j] = sum over blocks b = 0 .. G-1, in that order, of scratch[b, j]
__global__ void mlp_chain_bwd_reduce(const float* __restrict__ scratch, int G, size_t P,
                                     float* __restrict__ out) {
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += scratch[(size_t)b * P + j];
  out[j] = s;
}

size_t smem_bytes(int rm, int C, int H, int L1, int O) {
  const int tm = 16 * rm;
  int ld = C > H ? C : H;
  ld = (ld > O ? ld : O) + 1;
  return (size_t)((L1 + 4) * tm * ld + kTKc * kWsStride) * sizeof(float) +
         (size_t)(L1 + 1) * tm * H;
}

int row_tile_rm(int C, int H, int L1, int O) {
  for (int rm = 2; rm >= 1; rm /= 2)
    if (smem_bytes(rm, C, H, L1, O) <= kMaxSmem) return rm;
  return 0;
}

int n_blocks(int M, int rm) {
  const int tm = 16 * rm;
  const int n_tiles = (M + tm - 1) / tm;
  return n_tiles < kMaxBlocks ? n_tiles : kMaxBlocks;
}

template <int RM>
int launch(const float* x, const float* g, int M, int C, const float* w0, const float* b0,
           const float* wh, const float* bh, int L1, int H, const float* wout, int O,
           int is_res, float* dx, float* grads, float* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes(RM, C, H, L1, O);
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_bwd_kernel<RM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int G = n_blocks(M, RM);
  mlp_chain_bwd_kernel<RM><<<G, kThreads, smem, stream>>>(x, g, M, C, w0, b0, wh, bh, L1, H,
                                                          wout, O, is_res, dx, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t P = offsets(C, H, L1, O).total;
  mlp_chain_bwd_reduce<<<(unsigned)((P + 255) / 256), 256, 0, stream>>>(scratch, G, P, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch that npf_mlp_chain_bwd needs for these shapes (G slices
// of the flat gradient), or -1 when the widths exceed its shared memory.
extern "C" long long npf_mlp_chain_bwd_scratch(int M, int C, int H, int L1, int O) {
  const int rm = row_tile_rm(C, H, L1, O);
  if (rm == 0) return -1;
  return (long long)n_blocks(M, rm) * (long long)offsets(C, H, L1, O).total;
}

// x [M,C], g [M,O], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H]
// -> dx [M,C] and grads, the flat concatenation of dw0 [H,C], db0 [H],
// dwh [L1,H,H], dbh [L1,H], dwout [O,H], dbout [O]. float32, contiguous, on
// the current device; b0 and bh may be null; scratch holds
// npf_mlp_chain_bwd_scratch(...) floats and needs no initialisation. M >= 1.
// Launches the kernel and its reduction on `stream`, allocates nothing, does
// not synchronise. Returns the cudaError_t of the launches (0 on success).
extern "C" int npf_mlp_chain_bwd(const float* x, const float* g, int M, int C, const float* w0,
                                 const float* b0, const float* wh, const float* bh, int L1,
                                 int H, const float* wout, int O, int is_res, float* dx,
                                 float* grads, float* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (row_tile_rm(C, H, L1, O)) {
    case 2:
      return launch<2>(x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx, grads, scratch, s);
    case 1:
      return launch<1>(x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx, grads, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
