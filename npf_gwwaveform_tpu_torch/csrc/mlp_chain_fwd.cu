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
// (M = 65,536, C = H = 128, L1 = 3, O = 2) the chain is 65,792 multiply-adds
// a row, 8.6 GFLOP of f32 FMA (0.129 ms at 67 TFLOP/s), against 34 MB of
// input and output (0.010 ms at 3.35 TB/s): bound by f32 operations. Results
// must match the f32 chain at 1e-4 of their magnitude, so the products stay
// on FMA (TF32 tensor cores would need split products) and the design spends
// its effort on keeping the FMA pipe fed.
//
// Design (the fast kernel, for max(C, H) up to what its shared memory holds):
//  - One block per tile of rows: 64 rows below kBigTileRows rows of x (128
//    tiles at the training shape, one a SM), 128 rows from there. The tile's
//    activations stay in shared memory across every layer, stored transposed
//    (at[k * LD + row]), so only x is read and only out is written. With
//    H <= 128 every product is one 128-column pass and each layer's epilogue
//    writes over its own input, so one activation buffer suffices.
//  - The products are register-tiled f32 FMA: a thread holds an 8 x 8
//    accumulator tile, and a reduction step is four float4 loads of shared
//    memory for 64 FMAs, loaded one step ahead (tile_fma.cuh's layout with 8
//    rows a thread). With tile_fma.cuh's 4 x 8 tiles (three loads for 32
//    FMAs, 32-row blocks) this kernel took 1.3x (M = 8,192) and 1.9x
//    (M = 65,536) as long on the H100 (kernel_ab.py, PERF.md). The layer
//    epilogue (bias, ReLU, residual) writes the next layer's operand
//    directly in the transposed layout.
//  - Parallelism at M = 8,192: 64 rows a SM is all the work there is, which
//    8 x 8 tiles cover with four warps. So the small-M block has two groups
//    of 128 threads that split each weight chunk's features (split K) and
//    add their sums in a fixed order at the end of each product: eight warps
//    a SM, 1.1x faster than four. The 128-row block keeps two blocks a SM
//    (registers capped at 128 a thread, with a few spills).
//  - Weights are read in PyTorch's layout and transposed on the way in: each
//    16-feature x 128-column chunk goes through registers (float4 loads of
//    one column's features) into one of two shared buffers; the next chunk's
//    loads are issued before the current chunk's FMAs and stored after them,
//    and the last chunk of a product loads the next product's first one, so
//    L2 latency is hidden and each chunk costs one barrier. No transposed
//    copy, no scratch, one launch.
//  - Output layer: for O <= kSmallO (the decoder's O = 2) each row's output
//    is a dot product of its last activations with wout, summed by groups of
//    threads over contiguous feature ranges and then across the groups in a
//    fixed order, instead of a 128-column pass that would discard all but O
//    columns. Larger O takes the tiled product.
//  - L2 -> SM weight bytes per call: one read of every weight per block,
//    4 (C H + L1 H H + O H) ceil(M / TM): 33.7 MB at M = 8,192 (64-row
//    tiles) and 135 MB at M = 65,536 (128-row tiles), against 4.3 and 34 MB
//    of x and out.
//  - Determinism: every sum runs in a fixed order (no atomics), so two
//    launches on the same inputs give the same bits.
// Widths whose buffers exceed the fast blocks' shared memory (max(C, H) over
// 336, or C over 672 when H <= 128) take the wide kernel below (the earlier
// design: row-major activations, 32 or 16 rows a block), which accepts
// max(C, H) up to 1,686.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_fma.cuh"

namespace {

constexpr int kKC = 16;          // input features per staged weight chunk
constexpr int kTN = 128;         // output columns per pass of a product
constexpr int kBsLd = kTN + 4;
constexpr int kSmallO = 8;       // O <= kSmallO: the output layer is per-row dot products
constexpr int kMaxSmem = 232448;     // per-block shared memory on sm_90

// A fast kernel's block: NT threads in KS groups that split each chunk's
// features, RM accumulator rows a thread, at least MINB blocks an SM.
struct Cfg {
  int nt, rm, ks, minb;
};
constexpr Cfg kSmallCfg{256, 8, 2, 1};  // M < kBigTileRows
constexpr Cfg kBigCfg{256, 8, 1, 2};
constexpr int kBigTileRows = 16384;

// The tile of a group of NTG threads. Thread (rg, cg), with rg = 4 * (warp
// >> 1) + (lane >> 3) in [0, NTG / 16) and cg = 8 * (warp & 1) + (lane & 7)
// in [0, 16), owns rows {QS q + 4 rg + i} (q < RM / 4, i < 4) and columns
// {64 h + 4 cg + j} (h < 2, j < 4): acc[4 q + i][4 h + j]. (NTG = 128 and
// RM = 4 is tile_fma.cuh's layout.) A reduction step is RM / 4 + 2 float4
// loads of shared memory for 8 RM FMAs; a warp's loads touch 4 distinct
// float4s of the activations and 8 of the weights, one wavefront each.
template <int NTG, int RM>
struct Tile {
  static constexpr int QS = NTG / 4;       // row stride of a thread's row quads
  static constexpr int TM = QS * RM / 4;   // rows a block
  static constexpr int LD = TM + 4;        // +4: float4-aligned, distinct banks
};

__host__ __device__ inline int round_kc(int n) { return (n + kKC - 1) / kKC * kKC; }

// shared memory of a fast block: one activation buffer (one_buf) or two,
// two staged weight chunks, and the split-K partial sums
size_t fast_smem(Cfg g, bool one_buf, int C, int H) {
  const int kpad = round_kc(C > H ? C : H);
  const int ntg = g.nt / g.ks;
  const int tm = ntg / 16 * g.rm;
  return ((size_t)(one_buf ? 1 : 2) * kpad * (tm + 4) + 2 * kKC * kBsLd +
          (g.ks > 1 ? (size_t)ntg * g.rm * 8 : 0)) * sizeof(float);
}

// A thread's share of a staged weight chunk (kKC features x 128 columns):
// column n = n0 + tid % 128 and the KPC features k = k0 + (tid / 128) KPC + u
template <int NT>
struct Stage {
  static_assert(NT % kTN == 0, "a block stages whole columns");
  static constexpr int KPC = kKC * kTN / NT;
};

// v[u] = w[n * K + k] at the thread's (n, k), zero outside [0, N) x [0, K)
template <int NT>
__device__ __forceinline__ void load_w(float (&v)[Stage<NT>::KPC], const float* __restrict__ w,
                                       int K, int N, int n0, int k0, bool vec) {
  constexpr int KPC = Stage<NT>::KPC;
  const int kb = k0 + (int)(threadIdx.x / kTN) * KPC;
  const int n = n0 + (int)(threadIdx.x % kTN);
  const float* p = w + (size_t)(n < N ? n : 0) * K + kb;
  if (vec) {  // K % 4 == 0: each float4 lies wholly inside or outside [0, K)
#pragma unroll
    for (int u = 0; u < KPC; u += 4) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < N && kb + u < K) t = __ldg(reinterpret_cast<const float4*>(p + u));
      v[u] = t.x;
      v[u + 1] = t.y;
      v[u + 2] = t.z;
      v[u + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < KPC; ++u) v[u] = n < N && kb + u < K ? __ldg(p + u) : 0.f;
  }
}

// bs[k * kBsLd + n] = the chunk's W(k, n), from load_w's registers
template <int NT>
__device__ __forceinline__ void store_w(float* bs, const float (&v)[Stage<NT>::KPC]) {
  float* d = bs + (threadIdx.x / kTN) * Stage<NT>::KPC * kBsLd + threadIdx.x % kTN;
#pragma unroll
  for (int u = 0; u < Stage<NT>::KPC; ++u) d[u * kBsLd] = v[u];
}

// acc[4 q + i][4 h + j] += sum_{kk < KSTEPS} at[kk * LD + QS q + 4 rg + i]
//                                           * b[kk * kBsLd + 64 h + 4 cg + j],
// each step's operands loaded one step ahead
template <int NTG, int RM, int KSTEPS>
__device__ __forceinline__ void fma_chunk(float (&acc)[RM][8], const float* at, const float* b,
                                          int rg, int cg) {
  using T = Tile<NTG, RM>;
  float4 an[RM / 4], bn[2];
  auto load = [&](int kk) {
#pragma unroll
    for (int q = 0; q < RM / 4; ++q)
      an[q] = *reinterpret_cast<const float4*>(at + kk * T::LD + T::QS * q + 4 * rg);
    bn[0] = *reinterpret_cast<const float4*>(b + kk * kBsLd + 4 * cg);
    bn[1] = *reinterpret_cast<const float4*>(b + kk * kBsLd + 64 + 4 * cg);
  };
  load(0);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    float av[RM], bv[8];
#pragma unroll
    for (int q = 0; q < RM / 4; ++q) {
      av[4 * q] = an[q].x;
      av[4 * q + 1] = an[q].y;
      av[4 * q + 2] = an[q].z;
      av[4 * q + 3] = an[q].w;
    }
    bv[0] = bn[0].x; bv[1] = bn[0].y; bv[2] = bn[0].z; bv[3] = bn[0].w;
    bv[4] = bn[1].x; bv[5] = bn[1].y; bv[6] = bn[1].z; bv[7] = bn[1].w;
    if (kk + 1 < KSTEPS) load(kk + 1);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The weights of a product: w [N, K], in PyTorch's layout
struct Weights {
  const float* w;
  int K, N;
};

__device__ __forceinline__ bool vec_ok(const Weights& m) {
  return m.K % 4 == 0 && (reinterpret_cast<uintptr_t>(m.w) & 15) == 0;
}

// out(r, n) = sum_{k < K} at[k * LD + r] * w[n * K + k] for the tile's rows
// and every n < N, in passes of 128 columns. With KS = 2 groups, group g
// sums the features of each chunk's g-th half, and group 1's sums are added
// to group 0's through `red` (in that order). Group 0's threads hand their
// 4 x 4 blocks to epi(row0, col0, v). On entry `v` holds this thread's share
// of the first chunk (load_w); on exit, that of the first chunk of `next`
// (when next.w is not null), loaded during the last chunk's FMAs so the
// next product starts without waiting on L2. Begins with a barrier after
// staging its first chunk, so `at` may have been written just before by the
// previous epilogue; every read of `at` is done before epi runs, so epi may
// write over `at` when N <= 128.
template <int NT, int RM, int KS, typename Epi>
__device__ __forceinline__ void tile_product(const float* at, Weights m, Weights next, float* bs,
                                             float* red, int rg, int cg,
                                             float (&v)[Stage<NT>::KPC],
                                             Epi epi) {
  constexpr int NTG = NT / KS;
  constexpr int KSTEPS = kKC / KS;
  using T = Tile<NTG, RM>;
  const int grp = threadIdx.x / NTG;
  const int n_chunks = (m.K + kKC - 1) / kKC;
  const bool vec = vec_ok(m);
  for (int n0 = 0; n0 < m.N; n0 += kTN) {
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    store_w<NT>(bs, v);
    __syncthreads();  // chunk 0 and `at` are visible
    for (int c = 0; c < n_chunks; ++c) {
      const bool more = c + 1 < n_chunks;
      if (more) {
        load_w<NT>(v, m.w, m.K, m.N, n0, (c + 1) * kKC, vec);
      } else if (n0 + kTN < m.N) {
        load_w<NT>(v, m.w, m.K, m.N, n0 + kTN, 0, vec);
      } else if (next.w) {
        load_w<NT>(v, next.w, next.K, next.N, 0, 0, vec_ok(next));
      }
      fma_chunk<NTG, RM, KSTEPS>(acc, at + (c * kKC + grp * KSTEPS) * T::LD,
                                 bs + (c & 1) * kKC * kBsLd + grp * KSTEPS * kBsLd, rg, cg);
      if (more) store_w<NT>(bs + ((c + 1) & 1) * kKC * kBsLd, v);
      __syncthreads();  // chunk c + 1 is visible; every read of chunk c is done
    }
    if (n_chunks == 0 && n0 + kTN >= m.N && next.w)  // K = 0: nothing was loaded above
      load_w<NT>(v, next.w, next.K, next.N, 0, 0, vec_ok(next));
    if (KS > 1) {
      const int t = threadIdx.x % NTG;
      float4* red4 = reinterpret_cast<float4*>(red);
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            red4[(2 * i + h) * NTG + t] = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                                      acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
      __syncthreads();
      if (grp == 1) continue;  // uniform per warp; the next pass's barriers include it
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 r4 = red4[(2 * i + h) * NTG + t];
          acc[i][4 * h] += r4.x;
          acc[i][4 * h + 1] += r4.y;
          acc[i][4 * h + 2] += r4.z;
          acc[i][4 * h + 3] += r4.w;
        }
    }
#pragma unroll
    for (int q = 0; q < RM / 4; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col0 = n0 + 64 * h + 4 * cg;
        if (col0 >= m.N) continue;
        float blk[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) blk[i][j] = acc[4 * q + i][4 * h + j];
        epi(T::QS * q + 4 * rg, col0, blk);
      }
  }
}

// ONE: one activation buffer, each layer's epilogue writing over its input
// (H <= 128, so every product is one pass)
template <int NT, int RM, int KS, int MINB, bool ONE>
__global__ void __launch_bounds__(NT, MINB)
mlp_chain_fwd_fast(const float* __restrict__ x, int M, int C, const float* __restrict__ w0,
                   const float* __restrict__ b0, const float* __restrict__ wh,
                   const float* __restrict__ bh, int L1, int H, const float* __restrict__ wout,
                   const float* __restrict__ bout, int O, int is_res, float* __restrict__ out,
                   int kpad) {
  constexpr int NTG = NT / KS;
  using T = Tile<NTG, RM>;
  constexpr int TM = T::TM;
  constexpr int LD = T::LD;
  extern __shared__ __align__(16) float smem[];
  float* buf0 = smem;                              // [kpad, LD] x, then a_1, a_3, ...
  float* buf1 = ONE ? buf0 : buf0 + kpad * LD;     // [kpad, LD] a_0, a_2, ...
  float* bs = buf1 + kpad * LD;                    // two staged weight chunks
  float* red = bs + 2 * kKC * kBsLd;               // group 1's partial sums (KS = 2)
  const int tid = threadIdx.x;
  const int t = tid % NTG;
  const int rg = 4 * (t >> 6) + ((t & 31) >> 3);
  const int cg = 8 * ((t >> 5) & 1) + (t & 7);
  const int row0 = blockIdx.x * TM;

  // the first product's first chunk, in flight while x is read
  float v[Stage<NT>::KPC];
  load_w<NT>(v, w0, C, H, 0, 0, vec_ok(Weights{w0, C, H}));
  // features past a layer's width are read by its last chunk (times zero
  // weights): keep them finite. buf0 holds C features, then H; buf1 H.
  for (int e = C * LD + tid; e < kpad * LD; e += NT) buf0[e] = 0.f;
  if (!ONE)
    for (int e = H * LD + tid; e < kpad * LD; e += NT) buf1[e] = 0.f;
  // x, transposed; consecutive threads take consecutive rows; eight loads
  // in flight a thread before their stores
  if (C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int n = TM * (C / 4);
    for (int e0 = tid; e0 < n; e0 += 8 * NT) {
      float4 t4[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * NT;
        const int r = e % TM;
        t4[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < n && row0 + r < M)
          t4[u] = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * C + 4 * (e / TM)));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * NT;
        if (e >= n) break;
        float* d = buf0 + 4 * (e / TM) * LD + e % TM;
        d[0] = t4[u].x;
        d[LD] = t4[u].y;
        d[2 * LD] = t4[u].z;
        d[3 * LD] = t4[u].w;
      }
    }
  } else {
    for (int e = tid; e < TM * C; e += NT) {
      const int r = e % TM;
      const int c = e / TM;
      buf0[c * LD + r] = row0 + r < M ? __ldg(x + (size_t)(row0 + r) * C + c) : 0.f;
    }
  }

  // a hidden layer's epilogue: bias, ReLU, residual, into `dst` transposed
  auto hidden = [&](const float* bias, const float* src, float* dst, bool res) {
    return [=](int r0, int n0, float(&v)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j >= H) continue;
        const float b = bias ? __ldg(bias + n0 + j) : 0.f;
        float u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          u[i] = fmaxf(v[i][j] + b, 0.f);
          if (res) u[i] += src[(n0 + j) * LD + r0 + i];
        }
        *reinterpret_cast<float4*>(dst + (n0 + j) * LD + r0) = make_float4(u[0], u[1], u[2], u[3]);
      }
    };
  };
  // the products in order, each staging the next one's first chunk
  const Weights w_out{O > kSmallO ? wout : nullptr, H, O};
  auto hidden_w = [&](int l) {
    return l < L1 ? Weights{wh + (size_t)l * H * H, H, H} : w_out;
  };
  tile_product<NT, RM, KS>(buf0, Weights{w0, C, H}, hidden_w(0), bs, red, rg, cg, v,
                           hidden(b0, buf0, buf1, false));
  float* cur = buf1;
  float* nxt = buf0;
  for (int l = 0; l < L1; ++l) {
    tile_product<NT, RM, KS>(cur, hidden_w(l), hidden_w(l + 1), bs, red, rg, cg, v,
                             hidden(bh ? bh + (size_t)l * H : nullptr, cur, nxt, is_res != 0));
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (O > kSmallO) {
    tile_product<NT, RM, KS>(cur, w_out, Weights{nullptr, 0, 0}, bs, red, rg, cg, v,
                             [=](int r0, int n0, float(&b)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bias = bout && n0 + j < O ? __ldg(bout + n0 + j) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i][j] += bias;
      }
      npf::store_block(out, O, row0 + r0, M, n0, O, b);
    });
    return;
  }
  // small O: thread (part, r) sums row r's products over features
  // [part * span, (part + 1) * span); the parts are then added in order
  constexpr int kParts = NT / TM;
  static_assert(kParts * TM == NT && kParts * kSmallO * TM <= 2 * kKC * kBsLd, "small-O split");
  __syncthreads();  // the last activations are visible
  {
    const int r = tid % TM;
    const int part = tid / TM;
    const int span = (H + kParts - 1) / kParts;
    const int k1 = min(H, (part + 1) * span);
    float s[kSmallO];
#pragma unroll
    for (int o = 0; o < kSmallO; ++o) s[o] = 0.f;
#pragma unroll 4
    for (int k = part * span; k < k1; ++k) {
      const float a = cur[k * LD + r];
#pragma unroll
      for (int o = 0; o < kSmallO; ++o)
        if (o < O) s[o] = fmaf(a, __ldg(wout + (size_t)o * H + k), s[o]);
    }
#pragma unroll
    for (int o = 0; o < kSmallO; ++o)
      if (o < O) bs[(part * kSmallO + o) * TM + r] = s[o];
  }
  __syncthreads();
  for (int e = tid; e < TM * O; e += NT) {
    const int r = e / O;
    const int o = e - r * O;
    float s = bout ? __ldg(bout + o) : 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) s += bs[(p * kSmallO + o) * TM + r];
    if (row0 + r < M) out[(size_t)(row0 + r) * O + o] = s;
  }
}

// The wide kernel: 256 threads, 16 x RM rows a block, activations row-major
// in shared memory (two buffers of max(C, H) + 1 floats a row), each layer's
// weights staged transposed in chunks of 32 features x 128 columns, a
// RM x 8 accumulator tile a thread. Takes the widths whose transposed
// 32-row buffers exceed the fast kernel's shared memory.
constexpr int kWideThreads = 256;
constexpr int kWideKc = 32;
constexpr int kWideWsLd = kTN + 1;  // +1: the transposed store hits distinct banks

template <int RM>
__device__ __forceinline__ void wide_layer(const float* a_in, int lda, int kd,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias, int n_out, bool relu,
                                           bool res, float* a_out, float* out_g, int row0, int M,
                                           float* ws) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int n0 = 0; n0 < n_out; n0 += kTN) {
    float acc[RM][8];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < kd; k0 += kWideKc) {
      const int nk = min(kWideKc, kd - k0);
      for (int e = tid; e < kTN * kWideKc; e += kWideThreads) {
        const int n = e / kWideKc;
        const int kk = e - n * kWideKc;
        float v = 0.f;
        if (n0 + n < n_out && kk < nk) v = w[(size_t)(n0 + n) * kd + k0 + kk];
        ws[kk * kWideWsLd + n] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        float a[RM], b[8];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = a_in[(ty + 16 * i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = ws[kk * kWideWsLd + tx + 16 * j];
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
__global__ void __launch_bounds__(kWideThreads)
mlp_chain_fwd_wide(const float* __restrict__ x, int M, int C, const float* __restrict__ w0,
                   const float* __restrict__ b0, const float* __restrict__ wh,
                   const float* __restrict__ bh, int L1, int H, const float* __restrict__ wout,
                   const float* __restrict__ bout, int O, int is_res, float* __restrict__ out) {
  constexpr int TM = 16 * RM;
  extern __shared__ float smem[];
  const int lda = max(C, H) + 1;  // +1: the two row groups of a warp hit distinct banks
  float* a0 = smem;
  float* a1 = a0 + TM * lda;
  float* ws = a1 + TM * lda;
  const int row0 = blockIdx.x * TM;

  for (int e = threadIdx.x; e < TM * C; e += kWideThreads) {
    const int r = e / C;
    const int c = e - r * C;
    a0[r * lda + c] = row0 + r < M ? x[(size_t)(row0 + r) * C + c] : 0.f;
  }
  __syncthreads();

  wide_layer<RM>(a0, lda, C, w0, b0, H, true, false, a1, nullptr, row0, M, ws);
  float* cur = a1;
  float* nxt = a0;
  for (int l = 0; l < L1; ++l) {
    wide_layer<RM>(cur, lda, H, wh + (size_t)l * H * H, bh ? bh + (size_t)l * H : nullptr, H,
                   true, is_res != 0, nxt, nullptr, row0, M, ws);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  wide_layer<RM>(cur, lda, H, wout, bout, O, false, false, nullptr, out, row0, M, ws);
}

size_t wide_smem(int rm, int C, int H) {
  const int lda = (C > H ? C : H) + 1;
  return (size_t)(2 * 16 * rm * lda + kWideKc * kWideWsLd) * sizeof(float);
}

// The launch the entry point makes for these shapes: a kernel and its
// shared memory, or none when the widths exceed every kernel's.
enum class Kind { kNone, kSmall, kBig, kWide2, kWide1 };

struct Plan {
  Kind kind = Kind::kNone;
  bool one_buf = false;
  size_t smem = 0;
};

Plan make_plan(int M, int C, int H) {
  Plan p;
  p.one_buf = H <= kTN;
  const bool big = M >= kBigTileRows;
  const Kind kinds[] = {big ? Kind::kBig : Kind::kSmall, Kind::kSmall};
  const Cfg cfgs[] = {big ? kBigCfg : kSmallCfg, kSmallCfg};
  for (int i = 0; i < 2; ++i) {
    if (fast_smem(cfgs[i], p.one_buf, C, H) <= kMaxSmem) {
      p.kind = kinds[i];
      p.smem = fast_smem(cfgs[i], p.one_buf, C, H);
      return p;
    }
  }
  if (wide_smem(2, C, H) <= kMaxSmem) {
    p.kind = Kind::kWide2;
    p.smem = wide_smem(2, C, H);
  } else if (wide_smem(1, C, H) <= kMaxSmem) {
    p.kind = Kind::kWide1;
    p.smem = wide_smem(1, C, H);
  }
  return p;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int rows, size_t smem, int M, cudaStream_t stream,
                   int threads, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + rows - 1) / rows, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int NT, int RM, int KS, int MINB, typename... Args>
cudaError_t launch_fast(const Plan& p, int M, cudaStream_t stream, Args... args) {
  constexpr int rows = Tile<NT / KS, RM>::TM;
  return p.one_buf
             ? launch(mlp_chain_fwd_fast<NT, RM, KS, MINB, true>, rows, p.smem, M, stream, NT,
                      args...)
             : launch(mlp_chain_fwd_fast<NT, RM, KS, MINB, false>, rows, p.smem, M, stream, NT,
                      args...);
}

}  // namespace

// Bytes of shared memory a block of npf_mlp_chain_fwd takes at these
// shapes, or -1 when max(C, H) exceeds every kernel's shared memory.
extern "C" long long npf_mlp_chain_fwd_smem(int M, int C, int H, int O) {
  (void)O;  // the output width needs no shared memory of its own
  const Plan p = make_plan(M, C, H);
  return p.kind == Kind::kNone ? -1 : (long long)p.smem;
}

// x [M,C], w0 [H,C], b0 [H], wh [L1,H,H], bh [L1,H], wout [O,H], bout [O] -> out [M,O];
// float32, contiguous, on the current device; any bias pointer may be null.
// Launches one kernel on `stream` (the fast kernel with 32- or 64-row tiles,
// or the wide kernel past its widths), allocates nothing, does not
// synchronise. Returns the cudaError_t of the launch (0 on success).
extern "C" int npf_mlp_chain_fwd(const float* x, int M, int C, const float* w0, const float* b0,
                                 const float* wh, const float* bh, int L1, int H,
                                 const float* wout, const float* bout, int O, int is_res,
                                 float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Plan p = make_plan(M, C, H);
  const int kpad = round_kc(C > H ? C : H);
  switch (p.kind) {
    case Kind::kSmall:
      return (int)launch_fast<kSmallCfg.nt, kSmallCfg.rm, kSmallCfg.ks, kSmallCfg.minb>(
          p, M, s, x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, kpad);
    case Kind::kBig:
      return (int)launch_fast<kBigCfg.nt, kBigCfg.rm, kBigCfg.ks, kBigCfg.minb>(
          p, M, s, x, M, C, w0, b0, wh, bh, L1, H, wout, bout, O, is_res, out, kpad);
    case Kind::kWide2:
      return (int)launch(mlp_chain_fwd_wide<2>, 32, p.smem, M, s, kWideThreads, x, M, C, w0, b0,
                         wh, bh, L1, H, wout, bout, O, is_res, out);
    case Kind::kWide1:
      return (int)launch(mlp_chain_fwd_wide<1>, 16, p.smem, M, s, kWideThreads, x, M, C, w0, b0,
                         wh, bh, L1, H, wout, bout, O, is_res, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
