// Fused ReLU MLP chain backward in bfloat16 compute, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel
//   npf_gwwaveform_tpu/ops/pallas/mlp_chain_kernel.py::_bwd_kernel
//   at compute_dtype=bfloat16 (launcher _bwd_impl, the custom_vjp backward
//   of fused_relu_mlp).
//
// Forward (as csrc/mlp_chain_fwd_bf16.cu), for each row of x [M, C] (bf16):
//   a_0 = bf16(relu(x @ w0^T + b0))
//   a_{l+1} = bf16(relu(a_l @ wh[l]^T + bh[l])) (+ a_l, rounded, when is_res), l < L1
//   out = a_L1 @ wout^T + bout
// Given g = d loss / d out [M, O] (bf16), with masks m_l of the f32
// pre-activations, this computes (the rounding points: mlp_chain_bf16.cuh)
//   g_L1 = bf16(g @ wout); for l = L1 - 1 .. 0: p_{l+1} = g_{l+1} m_{l+1},
//   g_l = bf16(p_{l+1} @ wh[l]) (+ g_{l+1}, rounded, when is_res);
//   p_0 = g_0 m_0; dx = bf16(p_0 @ w0)
// and the f32 row sums dw0 = p_0^T x, dwh[l] = p_{l+1}^T a_l,
// dwout = g^T a_L1 and db = the row sums of p (of g for dbout), in PyTorch's
// Linear layout [out, in]. Weights and biases arrive as the model's f32
// parameters and are rounded to bf16 as they are read; any bias may be null.
//
// What bounds it on the H100: at the training shape (M = 8,192, C = H = 128,
// L1 = 3, O = 2) the forward recompute, the input gradients and the weight
// gradients are 4.3 GFLOP, 4.4 us at the bf16 tensor cores' 989 TFLOP/s,
// against 4.5 MB of bf16 x, g and dx and f32 weights and gradients (1.3 us
// at 3.35 TB/s): bound by operations. Like the forward, this first bf16
// kernel sums on the f32 FMA pipe, each input-gradient sum in the plain
// version's order, so that dx and every rounded g agree with the plain
// version bit for bit.
//
// Design: three launches on one stream, each sum in a fixed order (two
// launches on the same inputs give the same bits; no atomics).
//  1. rows (one block of 256 threads per tile of 32 rows): the row-parallel
//     chain in shared memory, transposed. The forward recompute keeps each
//     layer's ReLU mask as bytes (with is_res it cannot be read back from
//     a_{l+1}) and writes a_0..a_L1 to scratch; the backward walks the
//     layers down to dx through three buffers (g, p and the next g, which
//     the residual adds to g), writing p_0..p_L1 to scratch.
//  2. wgrad: each dW and db as a product over the rows, split by slices of
//     rows: a block owns a 64 x 64 tile of one layer's dW (and, in its first
//     column tile, that rows' db) over one slice, both bf16 operands staged
//     through shared memory 32 rows at a time, 4 x 4 f32 accumulators a
//     thread; each slice's sums go to scratch.
//  3. reduce: every dW and db value summed over the slices in slice order.
// Scratch: 2 (L1 + 1) M H bf16 values (the a_l and p_l, 16.8 MB at the
// training shape) and slices x the gradients' size in f32. Widths whose
// three buffers exceed the shared memory are refused before any launch.

#include <algorithm>

#include "mlp_chain_bf16.cuh"

namespace {

using namespace npf_bf16;

constexpr int kRM = 4;         // rows kernel: 32-row tiles
constexpr int kWT = 64;        // wgrad: a 64 (n) x 64 (k) tile of dW
constexpr int kWR = 32;        // wgrad: rows per staged chunk
constexpr int kWLd = kWT + 4;
constexpr int kMaxSlices = 64;
constexpr int kMinSliceRows = 128;
constexpr int kTargetBlocks = 4 * 132;

struct Offsets {  // of each gradient in the flat result, in floats
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

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The wgrad product of layer j: dW [N, K] = A^T B over the rows, db = A's row
// sums. j = 0: A = p_0 [M,H], B = x [M,C]; 1 <= j <= L1: A = p_j, B = a_{j-1}
// [M,H]; j = L1 + 1: A = g [M,O], B = a_L1.
struct WLayer {
  const __nv_bfloat16 *a, *b;
  int n, k;
  size_t off_w, off_b;
};

__host__ __device__ inline WLayer wlayer(int j, const __nv_bfloat16* x, const __nv_bfloat16* g,
                                         const __nv_bfloat16* acts, const __nv_bfloat16* gpre,
                                         int M, int C, int H, int L1, int O) {
  const Offsets o = offsets(C, H, L1, O);
  const size_t mh = (size_t)M * H;
  if (j == 0) return WLayer{gpre, x, H, C, o.dw0, o.db0};
  if (j <= L1)
    return WLayer{gpre + j * mh, acts + (j - 1) * mh, H, H, o.dwh + (size_t)(j - 1) * H * H,
                  o.dbh + (size_t)(j - 1) * H};
  return WLayer{g, acts + L1 * mh, O, H, o.dwout, o.dbout};
}

struct Plan {
  bool ok;
  int kpad;
  size_t smem;
  int n_wtiles, slices, slice_rows;
  size_t n_grads;
  size_t acts, gpre, part, total;  // scratch offsets and size, in bytes
};

Plan make_plan(int M, int C, int H, int L1, int O) {
  Plan p;
  p.kpad = std::max(C, std::max(H, O));
  constexpr int TM = Rows<kRM>::TM;
  p.smem = 3 * (size_t)p.kpad * Rows<kRM>::LDA * sizeof(float) + kStageBytes +
           ((size_t)(L1 + 1) * H * TM + 15) / 16 * 16;
  p.ok = M >= 1 && p.smem <= (size_t)kMaxSmem;
  p.n_wtiles = 0;
  for (int j = 0; j <= L1 + 1; ++j) {
    const WLayer w = wlayer(j, nullptr, nullptr, nullptr, nullptr, M, C, H, L1, O);
    p.n_wtiles += cdiv(w.n, kWT) * cdiv(w.k, kWT);
  }
  const int want = std::min(kMaxSlices, std::max(1, cdiv(kTargetBlocks, p.n_wtiles)));
  p.slice_rows = std::max(kMinSliceRows, cdiv(cdiv(std::max(M, 1), want), kWR) * kWR);
  p.slices = cdiv(std::max(M, 1), p.slice_rows);
  p.n_grads = offsets(C, H, L1, O).total;
  const size_t act_bytes = (size_t)(L1 + 1) * M * H * sizeof(__nv_bfloat16);
  p.acts = 0;
  p.gpre = align256(act_bytes);
  p.part = p.gpre + align256(act_bytes);
  p.total = p.part + (size_t)p.slices * p.n_grads * sizeof(float);
  return p;
}

__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_bf16_rows(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        int M, int C, const float* __restrict__ w0, const float* __restrict__ b0,
                        const float* __restrict__ wh, const float* __restrict__ bh, int L1, int H,
                        const float* __restrict__ wout, int O, int is_res,
                        __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ acts,
                        __nv_bfloat16* __restrict__ gpre, int kpad) {
  constexpr int TM = Rows<kRM>::TM;
  constexpr int LDA = Rows<kRM>::LDA;
  extern __shared__ __align__(16) float smem[];
  float* buf[3] = {smem, smem + (size_t)kpad * LDA, smem + 2 * (size_t)kpad * LDA};
  float* bs = buf[2] + (size_t)kpad * LDA;
  uint8_t* masks = reinterpret_cast<uint8_t*>(bs + kStageBytes / sizeof(float));  // [L1+1][H][TM]
  const int row0 = blockIdx.x * TM;
  const bool res = is_res != 0;
  const size_t mh = (size_t)M * H;

  // forward recompute: layer l's epilogue keeps its mask and writes a_l
  auto fwd = [=](const float* bias, const float* src, float* dst, bool add, int l) {
    uint8_t* mask = masks + (size_t)l * H * TM;
    __nv_bfloat16* act = acts + l * mh;
    return [=](int r, int n, float h) {
      if (bias) h += bfr(__ldg(bias + n));
      mask[n * TM + r] = h > 0.f;
      float a = bfr(fmaxf(h, 0.f));
      if (add) a = bfr(a + src[n * LDA + r]);
      dst[n * LDA + r] = a;
      if (row0 + r < M) act[(size_t)(row0 + r) * H + n] = __float2bfloat16_rn(a);
    };
  };
  stage_rows<kRM>(buf[0], x, row0, M, C);
  product<kRM, true>(buf[0], w0, C, H, bs, fwd(b0, buf[0], buf[1], false, 0));
  int cur = 1;
  for (int l = 0; l < L1; ++l) {
    product<kRM, true>(buf[cur], wh + (size_t)l * H * H, H, H, bs,
                       fwd(bh ? bh + (size_t)l * H : nullptr, buf[cur], buf[3 - cur], res, l + 1));
    cur = 3 - cur;
  }

  // p = g m_l into `p` (and scratch), row-major in scratch
  auto masked = [=](const float* gsrc, float* p, int l) {
    const uint8_t* mask = masks + (size_t)l * H * TM;
    __nv_bfloat16* dst = gpre + l * mh;
    for (int e = threadIdx.x; e < TM * H; e += kThreads) {
      const int r = e / H;
      const int n = e - r * H;
      const float v = mask[n * TM + r] ? gsrc[n * LDA + r] : 0.f;
      p[n * LDA + r] = v;
      if (row0 + r < M) dst[(size_t)(row0 + r) * H + n] = __float2bfloat16_rn(v);
    }
  };
  __syncthreads();  // every read of the forward's buffers is done
  stage_rows<kRM>(buf[0], g, row0, M, O);
  product<kRM, false>(buf[0], wout, O, H, bs,
                      [=](int r, int n, float h) { buf[1][n * LDA + r] = bfr(h); });
  int gi = 1;
  for (int l = L1 - 1; l >= 0; --l) {
    float* gc = buf[gi];
    float* p = buf[(gi + 1) % 3];
    float* nx = buf[(gi + 2) % 3];
    __syncthreads();  // g_{l+1} is visible
    masked(gc, p, l + 1);
    product<kRM, false>(p, wh + (size_t)l * H * H, H, H, bs, [=](int r, int k, float h) {
      float v = bfr(h);
      if (res) v = bfr(v + gc[k * LDA + r]);
      nx[k * LDA + r] = v;
    });
    gi = (gi + 2) % 3;
  }
  __syncthreads();
  float* p = buf[(gi + 1) % 3];
  masked(buf[gi], p, 0);
  product<kRM, false>(p, w0, H, C, bs, [=](int r, int c, float h) {
    if (row0 + r < M) dx[(size_t)(row0 + r) * C + c] = __float2bfloat16_rn(h);
  });
}

__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_bf16_wgrad(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ acts,
                         const __nv_bfloat16* __restrict__ gpre, int M, int C, int H, int L1,
                         int O, int slice_rows, size_t n_grads, float* __restrict__ part) {
  __shared__ __align__(16) float sa[kWR][kWLd];
  __shared__ __align__(16) float sb[kWR][kWLd];
  int t = blockIdx.x;
  WLayer w{};
  int nt = 0, kt = 0;
  for (int j = 0; j <= L1 + 1; ++j) {
    w = wlayer(j, x, g, acts, gpre, M, C, H, L1, O);
    const int tk = cdiv(w.k, kWT);
    const int tiles = cdiv(w.n, kWT) * tk;
    if (t < tiles) {
      nt = t / tk;
      kt = t - nt * tk;
      break;
    }
    t -= tiles;
  }
  const int n0 = nt * kWT, k0 = kt * kWT;
  const int r0 = blockIdx.y * slice_rows;
  const int r1 = min(M, r0 + slice_rows);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const bool bias = kt == 0 && tx == 0;
  float acc[4][4] = {}, db[4] = {};
  for (int rc = r0; rc < r1; rc += kWR) {
    __syncthreads();  // every read of the previous chunk is done
    for (int e = threadIdx.x; e < kWR * kWT; e += kThreads) {
      const int rr = e / kWT;
      const int c = e - rr * kWT;
      const int row = rc + rr;
      sa[rr][c] = row < r1 && n0 + c < w.n ? bf(w.a + (size_t)row * w.n + n0 + c) : 0.f;
      sb[rr][c] = row < r1 && k0 + c < w.k ? bf(w.b + (size_t)row * w.k + k0 + c) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kWR; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[rr][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[rr][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        if (bias) db[i] += av[i];
      }
    }
  }
  float* out = part + (size_t)blockIdx.y * n_grads;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * ty + i;
    if (n >= w.n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * tx + j;
      if (k < w.k) out[w.off_w + (size_t)n * w.k + k] = acc[i][j];
    }
    if (bias) out[w.off_b + n] = db[i];
  }
}

__global__ void mlp_chain_bwd_bf16_reduce(const float* __restrict__ part, int slices,
                                          size_t n_grads, float* __restrict__ grads) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n_grads;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += part[(size_t)k * n_grads + i];
    grads[i] = s;
  }
}

}  // namespace

// Bytes of scratch the backward takes; -1 when the widths exceed what a rows
// block can hold (nothing may be launched then).
extern "C" long long npf_mlp_chain_bwd_bf16_scratch(int M, int C, int H, int L1, int O) {
  const Plan p = make_plan(M, C, H, L1, O);
  return p.ok ? (long long)p.total : -1;
}

// x [M,C] bf16, g [M,O] bf16, w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H],
// wout [O,H] float32 -> dx [M,C] bf16 and grads, the flat float32
// concatenation of dw0 [H,C], db0 [H], dwh [L1,H,H], dbh [L1,H], dwout
// [O,H], dbout [O]; contiguous, on the current device; b0 and bh may be
// null; scratch holds npf_mlp_chain_bwd_bf16_scratch(...) bytes and needs
// no initialisation. M >= 1. Launches its three kernels on `stream`,
// allocates nothing, does not synchronise. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int npf_mlp_chain_bwd_bf16(const void* x, const void* g, int M, int C, const float* w0,
                                      const float* b0, const float* wh, const float* bh, int L1,
                                      int H, const float* wout, int O, int is_res, void* dx,
                                      float* grads, void* scratch, void* stream) {
  const Plan p = make_plan(M, C, H, L1, O);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* base = static_cast<char*>(scratch);
  auto* acts = reinterpret_cast<__nv_bfloat16*>(base + p.acts);
  auto* gpre = reinterpret_cast<__nv_bfloat16*>(base + p.gpre);
  auto* part = reinterpret_cast<float*>(base + p.part);
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_bwd_bf16_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  mlp_chain_bwd_bf16_rows<<<cdiv(M, Rows<kRM>::TM), kThreads, p.smem, s>>>(
      xb, gb, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, static_cast<__nv_bfloat16*>(dx),
      acts, gpre, p.kpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_chain_bwd_bf16_wgrad<<<dim3(p.n_wtiles, p.slices), kThreads, 0, s>>>(
      xb, gb, acts, gpre, M, C, H, L1, O, p.slice_rows, p.n_grads, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<size_t>((p.n_grads + kThreads - 1) / kThreads, 1024);
  mlp_chain_bwd_bf16_reduce<<<blocks, kThreads, 0, s>>>(part, p.slices, p.n_grads, grads);
  return (int)cudaGetLastError();
}
