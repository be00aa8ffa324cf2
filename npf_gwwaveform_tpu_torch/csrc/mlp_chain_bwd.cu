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
// L1 = 3, O = 2) the forward recompute and the input gradients are ~2.1 GFLOP
// and the weight gradients ~1.1 GFLOP of f32 FMA (~0.05 ms at 67 TFLOP/s),
// against ~8.5 MB of x, g, dx and weights (~2.5 us at 3.35 TB/s): bound by
// f32 operations. Results must match the f32 chain at 1e-4 of their
// magnitude, so tensor cores would need split 3xTF32 products; a trial of
// this design on mma.sync (three MMAs per product) was only 1.14x faster on
// the H100 and its errors were TF32's (up to 2e-3), so this version stays on
// FMA and spends its effort on keeping the FMA pipe fed.
//
// Design: four launches on one stream, each sum in a fixed order (two
// launches on the same inputs give the same bits; no atomics).
//  1. transpose: w0^T and wh[l]^T into scratch, so every weight operand of
//     the forward recompute is a row-major tile that cp.async can copy.
//  2. rows (one block of 128 threads per tile of 32 rows): the row-parallel
//     chain. The tile's activations stay in shared memory, stored transposed,
//     across every layer: recompute a_0..a_L1 keeping each layer's ReLU mask
//     as bits (with is_res it cannot be read back from a_{l+1}), then walk the
//     layers backwards (gpre = g * mask; g = gpre @ W (+ g when residual))
//     down to dx. Every product is [32 x K] x [K x N], in passes of 128
//     columns when N > 128; the tile's activations and gradients take two
//     [K x 32] buffers, and a third when H > 128 (a pass must not overwrite
//     the rows of its left operand that a later pass reads). Weights stream
//     through shared memory in 16-row chunks, three in flight (cp.async), and
//     each thread holds a 4 x 8 f32 accumulator tile in registers
//     (tile_fma.cuh). 64-row tiles (8 x 8 a thread, fewer shared-memory reads
//     per FMA) were 1.5x slower at M = 8,192 on the H100: half as many
//     blocks, one a SM, leave the barriers and loads exposed. The block
//     writes the layer inputs a_0..a_{L1-1} and the masked gradients
//     gpre_0..gpre_L1 of its rows to scratch, and the output layer's
//     dwout/dbout summed over its 32 rows (O x H is small). 65 KB of shared
//     memory and 167 registers at the training widths: three blocks fit an
//     SM.
//  3. wgrad: dW_l = gpre_l^T a_l (a_{-1} = x) and db_l = sum_rows gpre_l as
//     split-K products over the rows. A block owns a 128 x 64 tile of one
//     layer's dW and a slice of M / 32 rows (at least 128), and accumulates
//     it in registers (8 x 8 a thread) over the slice's whole row range, both
//     operands streaming through shared memory with cp.async. Partial sums:
//     at most 32 slices of the 66,048 dw0/dwh/db values (8.5 MB), where the
//     first version kept 128 (34 MB); 16 slices (one block a SM at the
//     training shape) made this kernel 1.8x slower.
//  4. reduce: the slices in slice order, and the rows kernel's per-tile
//     dwout/dbout in tile order (a warp per value, a fixed shuffle tree).
// The price of separating 2 and 3 is the scratch that carries the layer
// inputs and masked gradients between them: (2 L1 + 1) x M x H floats, 29 MB
// at the training shape, written once and read once, mostly from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tile_fma.cuh"

namespace {

using npf::cp_async_commit;
using npf::stage_tile;

constexpr int kThreads = 128;
constexpr int kTN = 128;            // output columns per pass of a rows-kernel product
constexpr int kKC = 16;             // weight rows per staged chunk
constexpr int kRowsRm = 4;          // rows kernel: 4 x 8 accumulators a thread, 32-row tiles
constexpr int kStages = 3;          // staged chunks: two in flight while one is used
constexpr int kBsLd = kTN + 4;
constexpr int kMaxSmem = 232448;    // per-block shared memory on sm_90
// wgrad kernel: a 128 (n) x 64 (k) tile of dW, 16 rows per staged chunk
constexpr int kWN = 128;
constexpr int kWK = 64;
constexpr int kWR = 16;
constexpr int kWPLd = kWN + 4;
constexpr int kWALd = kWK + 4;
constexpr int kWStages = 3;
constexpr int kMaxSlices = 32;
constexpr int kMinSliceRows = 128;

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

struct Offsets {  // of each gradient in the flat result
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

struct Plan {
  int rm = 0;  // kRowsRm, or 0 when the widths exceed the rows kernel's shared memory
  int tm, n_tiles, kpad, opad, n_pass;
  size_t smem;
  int slices, slice_rows, n_wtiles;
  size_t r1, n_out;  // dw0..dbh values (the wgrad kernel's), dwout + dbout values
  // scratch offsets, in floats
  size_t wt0, wth, acts, gpre, part_w, part_out, total;
};

// [kpad, LD] activation/gradient buffers of the rows kernel: two, and a
// third when a product takes more than one pass (see the backward below)
__host__ __device__ inline int n_bufs(int n_pass) { return n_pass > 1 ? 3 : 2; }

size_t rows_smem(int rm, int kpad, int opad, int n_pass, int L1) {
  const int ld = 8 * rm + 4;
  return (size_t)((n_bufs(n_pass) * kpad + opad) * ld + kStages * kKC * kBsLd) * sizeof(float) +
         (size_t)(L1 + 1) * n_pass * (rm / 2) * kThreads * sizeof(uint16_t);
}

Plan make_plan(int M, int C, int H, int L1, int O) {
  Plan p;
  p.kpad = (std::max(C, H) + kKC - 1) / kKC * kKC;
  p.opad = (O + kKC - 1) / kKC * kKC;
  p.n_pass = (H + kTN - 1) / kTN;
  const size_t smem = rows_smem(kRowsRm, p.kpad, p.opad, p.n_pass, L1);
  if (smem <= (size_t)kMaxSmem) {
    p.rm = kRowsRm;
    p.smem = smem;
  }
  if (p.rm == 0) return p;
  p.tm = 8 * p.rm;
  p.n_tiles = (M + p.tm - 1) / p.tm;
  p.slices = std::min(kMaxSlices, std::max(1, (M + kMinSliceRows - 1) / kMinSliceRows));
  p.slice_rows = ((M + p.slices - 1) / p.slices + kWR - 1) / kWR * kWR;
  p.slices = (M + p.slice_rows - 1) / p.slice_rows;
  const int ntn = (H + kWN - 1) / kWN;
  p.n_wtiles = ntn * ((C + kWK - 1) / kWK + L1 * ((H + kWK - 1) / kWK));
  const Offsets off = offsets(C, H, L1, O);
  p.r1 = off.dwout;
  p.n_out = off.total - off.dwout;
  p.wt0 = 0;
  p.wth = p.wt0 + round4((size_t)C * H);
  p.acts = p.wth + round4((size_t)L1 * H * H);
  p.gpre = p.acts + round4((size_t)L1 * M * H);
  p.part_w = p.gpre + round4((size_t)(L1 + 1) * M * H);
  p.part_out = p.part_w + round4((size_t)p.slices * p.r1);
  p.total = p.part_out + (size_t)p.n_tiles * p.n_out;
  return p;
}

// wt0[k * H + n] = w0[n * C + k]; wth[l][k * H + n] = wh[l][n * H + k]
__global__ void mlp_chain_bwd_transpose(const float* __restrict__ w0,
                                        const float* __restrict__ wh, int C, int H, int L1,
                                        float* __restrict__ wt0, float* __restrict__ wth) {
  const size_t n0 = (size_t)C * H;
  const size_t n = n0 + (size_t)L1 * H * H;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < n0) {
      const int k = (int)(e / H);
      const int j = (int)(e - (size_t)k * H);
      wt0[e] = w0[(size_t)j * C + k];
    } else {
      const size_t f = e - n0;
      const size_t l = f / ((size_t)H * H);
      const int r = (int)(f - l * H * H);
      const int k = r / H;
      const int j = r - k * H;
      wth[f] = wh[l * H * H + (size_t)j * H + k];
    }
  }
}

// out(r, n) = sum_{k < K} at[k * LD + r] * W(k, n), W(k, n) = w[k * ldw + n],
// for the tile's rows and every n < N in passes of 128 columns; each
// thread's 4 x 4 blocks go to epi(pass, block, row0, col0, v). Begins and
// ends with a barrier, so `at` may be rewritten by the epilogue.
template <int RM, typename Epi>
__device__ __forceinline__ void tile_gemm(const float* at, int K, const float* __restrict__ w,
                                          int ldw, int N, float* bs, int rg, int cg, Epi epi) {
  constexpr int LD = 8 * RM + 4;
  const int n_chunks = (K + kKC - 1) / kKC;
  for (int p = 0; p * kTN < N; ++p) {
    const int n0 = p * kTN;
    const bool vec = npf::can_vec(w, ldw, n0, N);
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks)
        stage_tile<kKC, kTN, kThreads>(bs + c * kKC * kBsLd, kBsLd, w, ldw, c * kKC, K, n0, N,
                                       vec);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      npf::cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c is visible; every thread is done with chunk c - 1
      const int next = c + kStages - 1;
      if (next < n_chunks)
        stage_tile<kKC, kTN, kThreads>(bs + (next % kStages) * kKC * kBsLd, kBsLd, w, ldw,
                                       next * kKC, K, n0, N, vec);
      cp_async_commit();
      npf::fma_tile<RM, kKC>(acc, at + c * kKC * LD, LD, bs + (c % kStages) * kKC * kBsLd,
                             kBsLd, rg, cg);
    }
    __syncthreads();  // every read of `at` and `bs` is done
#pragma unroll
    for (int q = 0; q < RM / 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col0 = n0 + 64 * h + 4 * cg;
        if (col0 >= N) continue;
        float v[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) v[i][j] = acc[4 * q + i][4 * h + j];
        epi(p, 2 * q + h, 32 * q + 4 * rg, col0, v);
      }
  }
  __syncthreads();  // the epilogue's writes are visible
}

// MULTI: n_pass > 1 (a separate instantiation, so that the one-pass kernel
// keeps its gradient in buf0 at compile time)
template <int RM, bool MULTI>
__global__ void __launch_bounds__(kThreads, 2)
mlp_chain_bwd_rows(const float* __restrict__ x, const float* __restrict__ g, int M, int C,
                   const float* __restrict__ w0, const float* __restrict__ b0,
                   const float* __restrict__ wh, const float* __restrict__ bh, int L1, int H,
                   const float* __restrict__ wout, int O, int is_res,
                   const float* __restrict__ wt0, const float* __restrict__ wth,
                   float* __restrict__ acts, float* __restrict__ gpre,
                   float* __restrict__ part_out, float* __restrict__ dx, int kpad, int opad,
                   int n_pass) {
  constexpr int TM = 8 * RM;
  constexpr int LD = TM + 4;
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;               // [kpad, LD] transposed tile: x, then a_1, a_3, ...; gpre
  float* buf1 = buf0 + kpad * LD;   // [kpad, LD] a_0, a_2, ...; the residual gradient
  float* gT = buf1 + kpad * LD;     // [opad, LD] the tile of g, transposed
  // [kpad, LD] the other gpre buffer when n_pass > 1 (else buf0 itself)
  float* buf2 = MULTI ? gT + opad * LD : buf0;
  float* bs = gT + opad * LD + (MULTI ? kpad * LD : 0);  // kStages staged weight chunks
  uint16_t* masks = reinterpret_cast<uint16_t*>(bs + kStages * kKC * kBsLd);
  const int tid = threadIdx.x;
  const int rg = npf::tile_rg();
  const int cg = npf::tile_cg();
  const int row0 = blockIdx.x * TM;
  const size_t MH = (size_t)M * H;
  // a thread's ReLU bits of one 4 x 4 block (bit 4 i + j) of layer li's output
  auto mask_at = [&](int li, int p, int blk) -> uint16_t& {
    return masks[((li * n_pass + p) * (RM / 2) + blk) * kThreads + tid];
  };

  // rows past a layer's width are read (times zero weights): keep them finite
  for (int e = tid; e < (n_bufs(n_pass) * kpad + opad) * LD; e += kThreads) smem[e] = 0.f;
  __syncthreads();
  for (int e = tid; e < TM * C; e += kThreads) {
    const int r = e / C;
    const int c = e - r * C;
    buf0[c * LD + r] = row0 + r < M ? x[(size_t)(row0 + r) * C + c] : 0.f;
  }
  for (int e = tid; e < TM * O; e += kThreads) {
    const int r = e / O;
    const int o = e - r * O;
    gT[o * LD + r] = row0 + r < M ? g[(size_t)(row0 + r) * O + o] : 0.f;
  }

  // forward recompute: layer li's output a_li (li = 0: the first layer)
  auto forward = [&](int li, const float* bias, const float* in, float* out, bool res) {
    float* gstore = li < L1 ? acts + (size_t)li * MH : nullptr;
    return [=, &mask_at](int p, int blk, int r0, int n0, float(&v)[4][4]) {
      uint16_t bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool col = n0 + j < H;
        const float b = bias && col ? bias[n0 + j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float u = v[i][j] + b;
          const bool on = u > 0.f;
          bits |= (uint16_t)on << (4 * i + j);
          v[i][j] = (on ? u : 0.f) + (res && col ? in[(n0 + j) * LD + r0 + i] : 0.f);
        }
        if (col)
          *reinterpret_cast<float4*>(out + (n0 + j) * LD + r0) =
              make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
      }
      mask_at(li, p, blk) = bits;
      if (gstore) npf::store_block(gstore, H, row0 + r0, M, n0, H, v);
    };
  };
  tile_gemm<RM>(buf0, C, wt0, H, H, bs, rg, cg, forward(0, b0, buf0, buf1, false));
  for (int l = 0; l < L1; ++l) {
    float* in = (l & 1) ? buf0 : buf1;  // a_l
    float* out = (l & 1) ? buf1 : buf0;
    tile_gemm<RM>(in, H, wth + (size_t)l * H * H, H, H, bs, rg, cg,
                  forward(l + 1, bh ? bh + (size_t)l * H : nullptr, in, out, is_res != 0));
  }
  const float* a_last = (L1 & 1) ? buf0 : buf1;

  // the output layer's weight and bias gradient over the tile's rows
  // (rows past M have g = 0)
  const int n_out = O * H + O;
  for (int e = tid; e < n_out; e += kThreads) {
    float s = 0.f;
    if (e < O * H) {
      const int o = e / H;
      const float* gr = gT + o * LD;
      const float* ar = a_last + (e - o * H) * LD;
      for (int r = 0; r < TM; ++r) s = fmaf(gr[r], ar[r], s);
    } else {
      const float* gr = gT + (e - O * H) * LD;
      for (int r = 0; r < TM; ++r) s += gr[r];
    }
    part_out[(size_t)blockIdx.x * n_out + e] = s;
  }
  __syncthreads();

  // backward: g (the gradient of a_li) arrives in v; gpre_li = g * mask_li
  // goes to gout (the next product's left operand) and to scratch; with
  // is_res, g itself is kept in buf1 for the skip connection of layer li.
  // A product that takes one pass has read all of its left operand before
  // its epilogue runs, so gpre may overwrite it (gout = buf0 throughout);
  // with more passes, pass 0's epilogue would overwrite rows that pass 1
  // still reads, so gpre alternates between buf0 and buf2.
  auto backward = [&](int li, bool add_res, float* gout) {
    float* gstore = gpre + (size_t)li * MH;
    return [=, &mask_at](int p, int blk, int r0, int n0, float(&v)[4][4]) {
      const uint16_t bits = mask_at(li, p, blk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j >= H) continue;
        float* res = buf1 + (n0 + j) * LD + r0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float u = v[i][j] + (add_res ? res[i] : 0.f);
          if (is_res) res[i] = u;
          v[i][j] = (bits >> (4 * i + j)) & 1 ? u : 0.f;
        }
        *reinterpret_cast<float4*>(gout + (n0 + j) * LD + r0) =
            make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
      }
      npf::store_block(gstore, H, row0 + r0, M, n0, H, v);
    };
  };
  float* gcur = buf0;
  tile_gemm<RM>(gT, O, wout, H, H, bs, rg, cg, backward(L1, false, gcur));
  for (int l = L1 - 1; l >= 0; --l) {
    float* gnext = MULTI && gcur == buf0 ? buf2 : buf0;
    tile_gemm<RM>(gcur, H, wh + (size_t)l * H * H, H, H, bs, rg, cg,
                  backward(l, is_res != 0, gnext));
    gcur = gnext;
  }
  tile_gemm<RM>(gcur, H, w0, C, C, bs, rg, cg,
                [=](int, int, int r0, int n0, float(&v)[4][4]) {
                  npf::store_block(dx, C, row0 + r0, M, n0, C, v);
                });
}

// part_w[slice] gets dW_l (and db_l from the k0 == 0 tiles) of one 128 x 64
// tile over the slice's rows: dW_l[n, k] = sum_r gpre_l[r, n] * in_l[r, k],
// in_0 = x, in_l = a_{l-1}.
__global__ void __launch_bounds__(kThreads)
mlp_chain_bwd_wgrad(const float* __restrict__ x, const float* __restrict__ acts,
                    const float* __restrict__ gpre, int M, int C, int H, int L1, int slice_rows,
                    size_t r1, float* __restrict__ part_w) {
  __shared__ __align__(16) float ps[kWStages][kWR * kWPLd];
  __shared__ __align__(16) float as[kWStages][kWR * kWALd];
  const int ntn = (H + kWN - 1) / kWN;
  const int ntk0 = (C + kWK - 1) / kWK;
  const int ntkh = (H + kWK - 1) / kWK;
  int t = blockIdx.x, li, tn, tk;
  if (t < ntn * ntk0) {
    li = 0;
    tn = t / ntk0;
    tk = t - tn * ntk0;
  } else {
    t -= ntn * ntk0;
    li = 1 + t / (ntn * ntkh);
    t -= (li - 1) * ntn * ntkh;
    tn = t / ntkh;
    tk = t - tn * ntkh;
  }
  const int kw = li == 0 ? C : H;
  const size_t MH = (size_t)M * H;
  const float* P = gpre + (size_t)li * MH;
  const float* A = li == 0 ? x : acts + (size_t)(li - 1) * MH;
  const int n0 = tn * kWN;
  const int k0 = tk * kWK;
  const int r_begin = blockIdx.y * slice_rows;
  const int r_end = min(M, r_begin + slice_rows);
  const int lane = threadIdx.x & 31;
  const int ng = 4 * (threadIdx.x >> 5) + (lane >> 3);  // rows n0 + 64 h + 4 ng + i
  const int kg = lane & 7;                               // columns k0 + 32 h + 4 kg + j
  const bool vec_p = npf::can_vec(P, H, n0, H);
  const bool vec_a = npf::can_vec(A, kw, k0, kw);
  const bool with_bias = k0 == 0;

  float acc[8][8], bsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int n_chunks = (r_end - r_begin + kWR - 1) / kWR;
  auto stage = [&](int c) {
    const int r0 = r_begin + c * kWR;
    stage_tile<kWR, kWN, kThreads>(ps[c % kWStages], kWPLd, P, H, r0, r_end, n0, H, vec_p);
    stage_tile<kWR, kWK, kThreads>(as[c % kWStages], kWALd, A, kw, r0, r_end, k0, kw, vec_a);
  };
  for (int c = 0; c < kWStages - 1; ++c) {
    if (c < n_chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    npf::cp_async_wait<kWStages - 2>();
    __syncthreads();
    if (c + kWStages - 1 < n_chunks) stage(c + kWStages - 1);
    cp_async_commit();
    const float* pc = ps[c % kWStages];
    const float* ac = as[c % kWStages];
#pragma unroll
    for (int rr = 0; rr < kWR; ++rr) {
      float pv[8], av[8];
      const float4 p0 = *reinterpret_cast<const float4*>(pc + rr * kWPLd + 4 * ng);
      const float4 p1 = *reinterpret_cast<const float4*>(pc + rr * kWPLd + 64 + 4 * ng);
      const float4 a0 = *reinterpret_cast<const float4*>(ac + rr * kWALd + 4 * kg);
      const float4 a1 = *reinterpret_cast<const float4*>(ac + rr * kWALd + 32 + 4 * kg);
      pv[0] = p0.x; pv[1] = p0.y; pv[2] = p0.z; pv[3] = p0.w;
      pv[4] = p1.x; pv[5] = p1.y; pv[6] = p1.z; pv[7] = p1.w;
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (with_bias) bsum[i] += pv[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], av[j], acc[i][j]);
      }
    }
  }

  const Offsets off = offsets(C, H, L1, 0);
  float* part = part_w + blockIdx.y * r1;
  float* dw = part + (li == 0 ? off.dw0 : off.dwh + (size_t)(li - 1) * H * H);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + 64 * (i >> 2) + 4 * ng + (i & 3);
    if (n >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 32 * (j >> 2) + 4 * kg + (j & 3);
      if (k < kw) dw[(size_t)n * kw + k] = acc[i][j];
    }
    if (with_bias && kg == 0)
      part[(li == 0 ? off.db0 : off.dbh + (size_t)(li - 1) * H) + n] = bsum[i];
  }
}

// grads[j] = sum over slices s, in order, of part_w[s, j] for j < r1; then
// grads[r1 + e] = sum over row tiles t of part_out[t, e], one warp per value
// (lane-strided, then a fixed shuffle tree)
__global__ void mlp_chain_bwd_reduce(const float* __restrict__ part_w, int slices, size_t r1,
                                     const float* __restrict__ part_out, int n_tiles,
                                     int n_out, int nb1, float* __restrict__ grads) {
  if ((int)blockIdx.x < nb1) {
    const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= r1) return;
    float s = 0.f;
    for (int b = 0; b < slices; ++b) s += part_w[(size_t)b * r1 + j];
    grads[j] = s;
    return;
  }
  const int e = (blockIdx.x - nb1) * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_out) return;  // uniform over the warp
  float s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) s += part_out[(size_t)t * n_out + e];
  s = npf::warp_sum(s);
  if (lane == 0) grads[r1 + e] = s;
}

template <int RM, bool MULTI>
cudaError_t launch_rows(const Plan& p, const float* x, const float* g, int M, int C,
                        const float* w0, const float* b0, const float* wh, const float* bh,
                        int L1, int H, const float* wout, int O, int is_res, float* dx,
                        float* scratch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mlp_chain_bwd_rows<RM, MULTI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  mlp_chain_bwd_rows<RM, MULTI><<<p.n_tiles, kThreads, p.smem, stream>>>(
      x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, scratch + p.wt0, scratch + p.wth,
      scratch + p.acts, scratch + p.gpre, scratch + p.part_out, dx, p.kpad, p.opad, p.n_pass);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that npf_mlp_chain_bwd needs for these shapes (the
// transposed weights, the layer inputs and masked gradients of every row,
// and the partial sums), or -1 when the widths exceed its shared memory.
extern "C" long long npf_mlp_chain_bwd_scratch(int M, int C, int H, int L1, int O) {
  const Plan p = make_plan(M, C, H, L1, O);
  return p.rm == 0 ? -1 : (long long)p.total;
}

// x [M,C], g [M,O], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H]
// -> dx [M,C] and grads, the flat concatenation of dw0 [H,C], db0 [H],
// dwh [L1,H,H], dbh [L1,H], dwout [O,H], dbout [O]. float32, contiguous, on
// the current device; b0 and bh may be null; scratch holds
// npf_mlp_chain_bwd_scratch(...) floats and needs no initialisation. M >= 1.
// Launches its four kernels on `stream`, allocates nothing, does not
// synchronise. Returns the cudaError_t of the launches (0 on success).
extern "C" int npf_mlp_chain_bwd(const float* x, const float* g, int M, int C, const float* w0,
                                 const float* b0, const float* wh, const float* bh, int L1,
                                 int H, const float* wout, int O, int is_res, float* dx,
                                 float* grads, float* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p = make_plan(M, C, H, L1, O);
  if (p.rm == 0 || M < 1) return (int)cudaErrorInvalidValue;
  const size_t n_t = (size_t)C * H + (size_t)L1 * H * H;
  if (n_t > 0) {
    const int blocks = (int)std::min((n_t + 255) / 256, (size_t)1024);
    mlp_chain_bwd_transpose<<<blocks, 256, 0, s>>>(w0, wh, C, H, L1, scratch + p.wt0,
                                                   scratch + p.wth);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err =
      p.n_pass > 1
          ? launch_rows<kRowsRm, true>(p, x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx,
                                       scratch, s)
          : launch_rows<kRowsRm, false>(p, x, g, M, C, w0, b0, wh, bh, L1, H, wout, O, is_res, dx,
                                        scratch, s);
  if (err != cudaSuccess) return (int)err;
  mlp_chain_bwd_wgrad<<<dim3(p.n_wtiles, p.slices), kThreads, 0, s>>>(
      x, scratch + p.acts, scratch + p.gpre, M, C, H, L1, p.slice_rows, p.r1,
      scratch + p.part_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nb1 = (int)((p.r1 + 255) / 256);
  const int nb2 = (int)((p.n_out + 7) / 8);
  mlp_chain_bwd_reduce<<<nb1 + nb2, 256, 0, s>>>(scratch + p.part_w, p.slices, p.r1,
                                                 scratch + p.part_out, p.n_tiles, (int)p.n_out,
                                                 nb1, grads);
  return (int)cudaGetLastError();
}
