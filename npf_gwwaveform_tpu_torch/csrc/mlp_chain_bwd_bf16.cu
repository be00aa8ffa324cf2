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
// pre-activations, this computes (the rounding points and the order of the
// sums: mlp_chain_bf16.cuh)
//   g_L1 = bf16(g @ wout); for l = L1 - 1 .. 0: p_{l+1} = g_{l+1} m_{l+1},
//   g_l = bf16(p_{l+1} @ wh[l]) (+ g_{l+1}, rounded, when is_res);
//   p_0 = g_0 m_0; dx = bf16(p_0 @ w0)
// and the f32 row sums dw0 = p_0^T x, dwh[l] = p_{l+1}^T a_l,
// dwout = g^T a_L1 and db = the row sums of p (of g for dbout), in PyTorch's
// Linear layout [out, in]. Weights and biases arrive as the model's f32
// parameters and are rounded to bf16 as they are staged; any bias may be
// null.
//
// What bounds it on the H100: at the training shape (M = 8,192, C = H = 128,
// L1 = 3, O = 2) the forward recompute, the input gradients and the weight
// gradients are 4.3 GFLOP, 4.4 us at the bf16 tensor cores' 989 TFLOP/s,
// against 4.5 MB of bf16 x, g and dx and f32 weights and gradients (1.3 us
// at 3.35 TB/s): bound by operations. So every product runs on the tensor
// cores (mma.sync m16n8k16, bf16 operands, f32 accumulators), as the Pallas
// kernel's run on the TPU's matrix unit.
//
// Design: three launches on one stream, each sum in a fixed order (two
// launches on the same inputs give the same bits; no atomics).
//  1. rows, on the tensor cores for C, H, O <= 128 with every weight in one
//     block's shared memory (csrc/mlp_chain_bf16_plan.h): a persistent grid
//     of at most one block of kBwdTcWarps (8) warps a SM stages every weight
//     once as bf16 (one copy serves both directions: ldmatrix reads it as
//     W^T for the forward and, with .trans, as W for the backward), then
//     each pair of warps walks its own 16-row tiles, as the forward kernel
//     does: the layer's input rows in the pair's row buffer, each warp half
//     the output columns, one pair barrier a layer. The forward recompute
//     keeps each warp's ReLU masks as 32 bits a lane and layer in shared
//     memory (with is_res a mask cannot be read back from a_{l+1}); the
//     backward keeps each warp's half of g_l in registers, writes p_l = g_l
//     m_l to the other row buffer, and runs g_L1 = g wout (k16 steps over O
//     padded with zeros), each p W product with the residual added in the
//     epilogue, and dx. Every product is settled against the plain version's
//     order (`settle`, mlp_chain_bf16.cuh), so its masks, a_l, p_l and dx
//     are the plain version's: a mask that flips would move a whole row of
//     dx. a_0..a_L1 and p_0..p_L1 also go to scratch, rows padded to hp =
//     pad16(H). At the training shape (512 tiles) the grid is 128 blocks of
//     four busy pairs. Wider chains take an f32-FMA rows kernel that sums
//     in the plain version's order (one block per 32-row tile, the chain
//     transposed in shared memory, weights streamed;
//     csrc/mlp_chain_bf16_fma.cuh).
//  2. wgrad, on the tensor cores on both paths: each dW = A^T B as a product
//     over the rows, split by slices of rows. A block owns a 64 x 64 tile of
//     one layer's dW over one slice; both bf16 operands go through shared
//     memory 32 rows at a time (the next chunk's loads in flight), and each
//     of the 8 warps takes a 16 x 32 sub-tile: ldmatrix.trans turns the
//     row-major A into the A fragments of A^T and the row-major B into B
//     fragments, two k16 steps a chunk. The blocks of a layer's first column
//     tile also sum db, one column a thread, rows in order. Each slice's sums
//     go to scratch.
//  3. reduce: every dW and db value summed over the slices in slice order.
// Scratch: 2 (L1 + 1) M ldh bf16 values (the a_l and p_l, 16.8 MB at the
// training shape) and slices x the gradients' size in f32. Widths whose
// FMA rows kernel's three buffers exceed the shared memory are refused
// before any launch.

#include <algorithm>

#include "mlp_chain_bf16_fma.cuh"

namespace {

using namespace npf_bf16;

constexpr int kWLd = kWT + kSkew;  // wgrad: staged row stride (bf16)
constexpr int kMinBusyPairs = 4;   // rows, tensor-core path: fewer blocks rather than idler warps

struct Offsets {  // of each gradient in the flat result, in floats
  size_t dw0, db0, dwh, dbh, dwout, dbout;
};

__host__ __device__ inline Offsets offsets(int C, int H, int L1, int O) {
  Offsets o;
  o.dw0 = 0;
  o.db0 = o.dw0 + (size_t)H * C;
  o.dwh = o.db0 + H;
  o.dbh = o.dwh + (size_t)L1 * H * H;
  o.dwout = o.dbh + (size_t)L1 * H;
  o.dbout = o.dwout + (size_t)O * H;
  return o;
}

__device__ inline int dcdiv(int a, int b) { return (a + b - 1) / b; }

// The wgrad product of layer j: dW [n, k] = A^T B over the rows, db = A's row
// sums. j = 0: A = p_0 [M,H], B = x [M,C]; 1 <= j <= L1: A = p_j, B = a_{j-1}
// [M,H]; j = L1 + 1: A = g [M,O], B = a_L1. Row strides lda, ldb.
struct WLayer {
  const __nv_bfloat16 *a, *b;
  int lda, ldb, n, k;
  size_t off_w, off_b;
};

__device__ inline WLayer wlayer(int j, const __nv_bfloat16* x, const __nv_bfloat16* g,
                                const __nv_bfloat16* acts, const __nv_bfloat16* gpre, int M,
                                int C, int H, int L1, int O, int ldh) {
  const Offsets o = offsets(C, H, L1, O);
  const size_t mh = (size_t)M * ldh;
  if (j == 0) return WLayer{gpre, x, ldh, C, H, C, o.dw0, o.db0};
  if (j <= L1)
    return WLayer{gpre + j * mh, acts + (j - 1) * mh, ldh, ldh, H, H,
                  o.dwh + (size_t)(j - 1) * H * H, o.dbh + (size_t)(j - 1) * H};
  return WLayer{g, acts + L1 * mh, O, ldh, O, H, o.dwout, o.dbout};
}

__global__ void __launch_bounds__(kBwdTcWarps * 32, 1)
mlp_chain_bwd_bf16_rows_tc(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ g, int M, int C,
                           const float* __restrict__ w0, const float* __restrict__ b0,
                           const float* __restrict__ wh, const float* __restrict__ bh, int L1,
                           int H, const float* __restrict__ wout, int O, int is_res,
                           __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ acts,
                           __nv_bfloat16* __restrict__ gpre, TcLayout L) {
  extern __shared__ __align__(16) float smem_f[];  // one declaration a file: the FMA kernel's
  auto* smem = reinterpret_cast<unsigned char*>(smem_f);
  auto* w0s = reinterpret_cast<__nv_bfloat16*>(smem + L.w0);
  auto* whs = reinterpret_cast<__nv_bfloat16*>(smem + L.wh);
  auto* wos = reinterpret_cast<__nv_bfloat16*>(smem + L.wo);
  auto* b0s = reinterpret_cast<float*>(smem + L.b0);
  auto* bhs = reinterpret_cast<float*>(smem + L.bh);
  const int ldc = L.cp + kSkew, ldw = L.hp + kSkew;
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
    stage_weight(whs + (size_t)l * L.hp * ldw, ldw, wh + (size_t)l * H * H, H, H, L.hp, L.hp);
  stage_weight(wos, ldw, wout, O, H, L.op, L.hp);
  stage_bias(b0s, b0, H, L.hp);
  for (int l = 0; l < L1; ++l)
    stage_bias(bhs + (size_t)l * L.hp, bh ? bh + (size_t)l * H : nullptr, H, L.hp);
  auto* wmax = reinterpret_cast<float*>(smem + L.wmax);  // [L1 + 2][2]
  for (int i = threadIdx.x; i < 2 * (L1 + 2); i += blockDim.x) wmax[i] = 0.f;
  put_rows(buf(0), ldr, C, rv);
  __syncthreads();
  stage_norm_max(wmax, w0s, ldc, L.hp, L.cp, true);
  for (int l = 0; l < L1; ++l)
    stage_norm_max(wmax + 2 * (l + 1), whs + (size_t)l * L.hp * ldw, ldw, L.hp, L.hp, true);
  stage_norm_max(wmax + 2 * (L1 + 1), wos, ldw, L.op, L.hp, true);
  __syncthreads();

  const FixList fix(smem + L.fix, L.warps, L.fixcap, warp);
  // this lane's mask of layer l: masks[l * kBwdTcWarps * 32]
  auto* masks = reinterpret_cast<uint32_t*>(smem + L.masks) + threadIdx.x;
  int j0, nt, jc, ntc;  // this warp's share of the hidden and of the input columns
  share(L.hp / 16, j0, nt);
  share(L.cp / 16, jc, ntc);
  const int ldh = L.hp;  // scratch row stride
  const size_t mh = (size_t)M * ldh;
  const int kt = L.hp / 16, kt0 = L.cp / 16, kto = L.op / 16;
  const bool res = is_res != 0;
  const bool gvec = (O & 1) == 0 && ((uintptr_t)g & 3) == 0;
  const bool dvec = (C & 1) == 0 && ((uintptr_t)dx & 3) == 0;
  const int n_tiles = (M + 15) / 16;
  float acc[kHalfNT][4];
  uint32_t gh[kHalfNT][2];  // this warp's share of g_l
  float n0, n1, wm;
  const int stride = kBwdTcWarps / 2 * gridDim.x;  // pairs of the grid
  for (int tile = first; tile < n_tiles; tile += stride) {
    const int row0 = tile * 16;
    // forward recompute: a_l (buffers and scratch) and m_l
    if (tile != first) {  // the first tile's rows are in
      pair_sync();  // the pair is done with the last tile's buffers
      fetch_rows(rv, x, C, xvec, row0, M);
      put_rows(buf(0), ldr, C, rv);
      pair_sync();
    }
    int cur = 0;
    for (int l = -1; l < L1; ++l) {  // to_hidden, then the hidden layers
      const bool first_layer = l < 0;
      const __nv_bfloat16* w = first_layer ? w0s : whs + (size_t)l * L.hp * ldw;
      const int ld = first_layer ? ldc : ldw;
      product<false>(acc, buf(cur), ldr, first_layer ? kt0 : kt, w, ld, j0, nt, n0, n1);
      wm = kFixEps * wmax[2 * (l + 1)];
      settle<false, true>(acc, nt, j0, H, first_layer ? b0s : bhs + (size_t)l * L.hp, wm * n0,
                          wm * n1, buf(cur), ldr, w, ld, first_layer ? L.cp : L.hp, fix);
      masks[(l + 1) * kBwdTcWarps * 32] =
          epi_hidden(acc, nt, j0, res && !first_layer, buf(cur), buf(1 - cur), ldr,
                     acts + (l + 1) * mh, ldh, row0, M);
      pair_sync();
      cur = 1 - cur;
    }
    // backward: g_L1 = bf16(g wout), then down the layers
    fetch_rows(rv, g, O, gvec, row0, M);
    put_rows(buf(1 - cur), ldr, O, rv);
    pair_sync();
    cur = 1 - cur;
    product<true>(acc, buf(cur), ldr, kto, wos, ldw, j0, nt, n0, n1);
    wm = kFixEps * wmax[2 * (L1 + 1) + 1];
    settle<true, false>(acc, nt, j0, H, nullptr, wm * n0, wm * n1, buf(cur), ldr, wos, ldw, L.op,
                        fix);
    epi_grad(acc, gh, nt, false);
    for (int l = L1 - 1; l >= 0; --l) {
      const __nv_bfloat16* w = whs + (size_t)l * L.hp * ldw;
      put_masked(gh, masks[(l + 1) * kBwdTcWarps * 32], nt, j0, buf(1 - cur), ldr,
                 gpre + (l + 1) * mh, ldh, row0, M);
      pair_sync();
      cur = 1 - cur;
      product<true>(acc, buf(cur), ldr, kt, w, ldw, j0, nt, n0, n1);
      wm = kFixEps * wmax[2 * (l + 1) + 1];
      settle<true, false>(acc, nt, j0, H, nullptr, wm * n0, wm * n1, buf(cur), ldr, w, ldw, L.hp,
                          fix);
      epi_grad(acc, gh, nt, res);
    }
    put_masked(gh, masks[0], nt, j0, buf(1 - cur), ldr, gpre, ldh, row0, M);
    pair_sync();
    cur = 1 - cur;
    product<true>(acc, buf(cur), ldr, kt, w0s, ldc, jc, ntc, n0, n1);
    wm = kFixEps * wmax[1];
    settle<true, false>(acc, ntc, jc, C, nullptr, wm * n0, wm * n1, buf(cur), ldr, w0s, ldc, L.hp,
                        fix);
    const int r = row0 + (lane >> 2), c = 2 * (lane & 3) + 8 * jc;
#pragma unroll
    for (int j = 0; j < kHalfNT; ++j) {
      if (j >= ntc) break;
      store_pair(dx, C, dvec, r, j * 8 + c, M, C, pack(acc[j][0], acc[j][1]));
      store_pair(dx, C, dvec, r + 8, j * 8 + c, M, C, pack(acc[j][2], acc[j][3]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_bf16_rows_fma(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ g, int M, int C,
                            const float* __restrict__ w0, const float* __restrict__ b0,
                            const float* __restrict__ wh, const float* __restrict__ bh, int L1,
                            int H, const float* __restrict__ wout, int O, int is_res,
                            __nv_bfloat16* __restrict__ dx, __nv_bfloat16* __restrict__ acts,
                            __nv_bfloat16* __restrict__ gpre, int kpad) {
  constexpr int TM = Rows<kFmaBwdRM>::TM;
  constexpr int LDA = Rows<kFmaBwdRM>::LDA;
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
  stage_rows<kFmaBwdRM>(buf[0], x, row0, M, C);
  product<kFmaBwdRM, true>(buf[0], w0, C, H, bs, fwd(b0, buf[0], buf[1], false, 0));
  int cur = 1;
  for (int l = 0; l < L1; ++l) {
    product<kFmaBwdRM, true>(buf[cur], wh + (size_t)l * H * H, H, H, bs,
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
  stage_rows<kFmaBwdRM>(buf[0], g, row0, M, O);
  product<kFmaBwdRM, false>(buf[0], wout, O, H, bs,
                      [=](int r, int n, float h) { buf[1][n * LDA + r] = bfr(h); });
  int gi = 1;
  for (int l = L1 - 1; l >= 0; --l) {
    float* gc = buf[gi];
    float* p = buf[(gi + 1) % 3];
    float* nx = buf[(gi + 2) % 3];
    __syncthreads();  // g_{l+1} is visible
    masked(gc, p, l + 1);
    product<kFmaBwdRM, false>(p, wh + (size_t)l * H * H, H, H, bs, [=](int r, int k, float h) {
      float v = bfr(h);
      if (res) v = bfr(v + gc[k * LDA + r]);
      nx[k * LDA + r] = v;
    });
    gi = (gi + 2) % 3;
  }
  __syncthreads();
  float* p = buf[(gi + 1) % 3];
  masked(buf[gi], p, 0);
  product<kFmaBwdRM, false>(p, w0, H, C, bs, [=](int r, int c, float h) {
    if (row0 + r < M) dx[(size_t)(row0 + r) * C + c] = __float2bfloat16_rn(h);
  });
}

__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_bf16_wgrad(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ acts,
                         const __nv_bfloat16* __restrict__ gpre, int M, int C, int H, int L1,
                         int O, int ldh, int slice_rows, size_t n_grads,
                         float* __restrict__ part) {
  __shared__ __align__(16) __nv_bfloat16 sa[kWR][kWLd];
  __shared__ __align__(16) __nv_bfloat16 sb[kWR][kWLd];
  int t = blockIdx.x;
  WLayer w{};
  int nt = 0, kt = 0;
  for (int j = 0; j <= L1 + 1; ++j) {
    w = wlayer(j, x, g, acts, gpre, M, C, H, L1, O, ldh);
    const int tk = dcdiv(w.k, kWT);
    const int tiles = dcdiv(w.n, kWT) * tk;
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = (warp & 3) * 16, wk = (warp >> 2) * 32;  // the warp's 16 x 32 sub-tile
  const bool bias = kt == 0 && threadIdx.x < kWT;
  const bool avec = (w.lda & 7) == 0 && ((uintptr_t)w.a & 15) == 0;
  const bool bvec = (w.ldb & 7) == 0 && ((uintptr_t)w.b & 15) == 0;
  // this thread's eight staged columns of one row of a chunk
  const int rr = threadIdx.x >> 3, cc = (threadIdx.x & 7) * 8;
  auto load8 = [&](const __nv_bfloat16* p, int ld, bool vec, int row, int col, int width) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row >= r1) return v;
    const __nv_bfloat16* q = p + (size_t)row * ld + col;
    if (vec && col + 8 <= width) return __ldg(reinterpret_cast<const uint4*>(q));
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = col + 2 * i < width ? __bfloat16_as_ushort(__ldg(q + 2 * i)) : 0u;
      const uint32_t hi = col + 2 * i + 1 < width ? __bfloat16_as_ushort(__ldg(q + 2 * i + 1)) : 0u;
      u[i] = lo | hi << 16;
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  };
  const uint32_t a_base =
      smem_u32(&sa[(lane & 7) + ((lane >> 4) << 3)][wn + ((lane >> 3) & 1) * 8]);
  const uint32_t b_base = smem_u32(&sb[(lane & 7) + ((lane >> 3) & 1) * 8][wk + (lane >> 4) * 8]);
  float acc[4][4] = {}, db = 0.f;
  uint4 va = load8(w.a, w.lda, avec, r0 + rr, n0 + cc, w.n);
  uint4 vb = load8(w.b, w.ldb, bvec, r0 + rr, k0 + cc, w.k);
  for (int rc = r0; rc < r1; rc += kWR) {
    __syncthreads();  // every read of the previous chunk is done
    *reinterpret_cast<uint4*>(&sa[rr][cc]) = va;
    *reinterpret_cast<uint4*>(&sb[rr][cc]) = vb;
    __syncthreads();
    if (rc + kWR < r1) {  // in flight during the products
      va = load8(w.a, w.lda, avec, rc + kWR + rr, n0 + cc, w.n);
      vb = load8(w.b, w.ldb, bvec, rc + kWR + rr, k0 + cc, w.k);
    }
    if (bias)
      for (int i = 0; i < kWR; ++i) db += __bfloat162float(sa[i][threadIdx.x]);
#pragma unroll
    for (int s = 0; s < kWR / 16; ++s) {
      uint32_t af[4], bf0[4], bf1[4];
      ldsm_x4_trans(af, a_base + 2u * (s * 16 * kWLd));
      ldsm_x4_trans(bf0, b_base + 2u * (s * 16 * kWLd));
      ldsm_x4_trans(bf1, b_base + 2u * (s * 16 * kWLd + 16));
      mma(acc[0], af, bf0[0], bf0[1]);
      mma(acc[1], af, bf0[2], bf0[3]);
      mma(acc[2], af, bf1[0], bf1[1]);
      mma(acc[3], af, bf1[2], bf1[3]);
    }
  }
  float* out = part + (size_t)blockIdx.y * n_grads;
  const int gr = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + wn + gr + (e >> 1) * 8;
      const int k = k0 + wk + j * 8 + tc + (e & 1);
      if (n < w.n && k < w.k) out[w.off_w + (size_t)n * w.k + k] = acc[j][e];
    }
  }
  if (bias && n0 + (int)threadIdx.x < w.n) out[w.off_b + n0 + threadIdx.x] = db;
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

// x [M,C] bf16, g [M,O] bf16, w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H],
// wout [O,H] float32 -> dx [M,C] bf16 and grads, the flat float32
// concatenation of dw0 [H,C], db0 [H], dwh [L1,H,H], dbh [L1,H], dwout
// [O,H], dbout [O]; contiguous, on the current device; b0 and bh may be
// null; scratch holds npf_mlp_chain_bwd_bf16_scratch(...) bytes
// (csrc/mlp_chain_bf16_plan.cu) and needs no initialisation. M >= 1.
// Launches its three kernels on `stream` (the plan's rows kernel), allocates
// nothing, does not synchronise. Returns the cudaError_t of the launches (0
// on success).
extern "C" int npf_mlp_chain_bwd_bf16(const void* x, const void* g, int M, int C, const float* w0,
                                      const float* b0, const float* wh, const float* bh, int L1,
                                      int H, const float* wout, int O, int is_res, void* dx,
                                      float* grads, void* scratch, void* stream) {
  const BwdPlan p = bwd_plan(M, C, H, L1, O);
  if (p.path == kPathRefused) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  auto* base = static_cast<char*>(scratch);
  auto* acts = reinterpret_cast<__nv_bfloat16*>(base + p.acts);
  auto* gpre = reinterpret_cast<__nv_bfloat16*>(base + p.gpre);
  auto* part = reinterpret_cast<float*>(base + p.part);
  cudaError_t err;
  if (p.path == kPathTensorCores) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mlp_chain_bwd_bf16_rows_tc,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = (M + 15) / 16;
    const int blocks = std::max(1, std::min(sms, (tiles + kMinBusyPairs - 1) / kMinBusyPairs));
    mlp_chain_bwd_bf16_rows_tc<<<blocks, kBwdTcWarps * 32, p.smem, s>>>(
        xb, gb, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dxb, acts, gpre, p.tc);
  } else {
    err = cudaFuncSetAttribute(mlp_chain_bwd_bf16_rows_fma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    const int kpad = std::max(C, std::max(H, O));
    mlp_chain_bwd_bf16_rows_fma<<<cdiv(M, Rows<kFmaBwdRM>::TM), kThreads, p.smem, s>>>(
        xb, gb, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dxb, acts, gpre, kpad);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_chain_bwd_bf16_wgrad<<<dim3(p.n_wtiles, p.slices), kThreads, 0, s>>>(
      xb, gb, acts, gpre, M, C, H, L1, O, p.ldh, p.slice_rows, p.n_grads, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (int)std::min<size_t>((p.n_grads + kThreads - 1) / kThreads, 1024);
  mlp_chain_bwd_bf16_reduce<<<blocks, kThreads, 0, s>>>(part, p.slices, p.n_grads, grads);
  return (int)cudaGetLastError();
}
