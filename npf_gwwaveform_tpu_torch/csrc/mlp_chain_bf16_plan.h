// The launch plans of the bfloat16 MLP-chain kernels (K2-bf16,
// csrc/mlp_chain_fwd_bf16.cu; K3-bf16, csrc/mlp_chain_bwd_bf16.cu): which
// kernel takes a call's widths, its shared memory and its scratch. Host code
// only, no CUDA header: the launchers and the C plan queries
// (csrc/mlp_chain_bf16_plan.cu) share it, and a host C++ compiler builds the
// queries alone for the CPU tests.
//
// Two paths. The tensor-core kernels hold a warp's 16 rows of every layer in
// mma.sync fragments, so they take C, H and O up to kTcMaxWidth, and every
// weight of the chain staged in one block's shared memory as bf16. The
// f32-FMA kernels (csrc/mlp_chain_bf16_fma.cuh) stream the weights in
// chunks and take the wider chains, up to what their activation buffers
// hold; past that, a call is refused before any launch.

#pragma once

#include <stddef.h>

namespace npf_bf16 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // per-block shared memory on sm_90

constexpr int kPathRefused = -1;
constexpr int kPathTensorCores = 1;
constexpr int kPathFma = 2;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int pad16(int v) { return cdiv(v, 16) * 16; }
inline size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// ---- tensor-core path

constexpr int kTcMaxWidth = 128;  // C, H and O, each padded to a multiple of 16
// bf16 elements past each staged weight row: a row is an odd number of
// 16-byte units, so the eight rows an ldmatrix reads fall in distinct banks
constexpr int kSkew = 8;

// Byte offsets in a tensor-core block's dynamic shared memory (the forward's
// block of kFwdTcWarps warps, or with `masks` the backward's of kBwdTcWarps): w0 [hp][cp +
// kSkew], wh [L1][hp][hp + kSkew] and wout [op][hp + kSkew] in bf16, zero
// padded; b0 [hp], bh [L1][hp] and bout [op] in f32 holding bf16 values;
// wmax [L1 + 2][2] f32, the largest L2 norm of a row and of a column of each
// staged weight (w0, wh[0..L1), wout), which bound each product's error;
// two row buffers [16][kp + kSkew] bf16 for each pair of warps (kp =
// max(cp, hp, op)): a product's input rows and its output, in row-major
// order, that the pair's two warps share and the plain-order sums read; the
// pair's
// fix-up list (2 fixcap entries and their sums) and its two warps' counts;
// and with `masks` (the
// backward), each warp's ReLU masks, 32 bits a lane and layer.
// warps of a tensor-core block, and fix-up entries a warp: K2-bf16's 16 warps
// hide more latency; K3-bf16's registers leave room for 8, and its shared
// memory for longer lists
constexpr int kFwdTcWarps = 16, kFwdFixCap = 32;
constexpr int kBwdTcWarps = 8, kBwdFixCap = 64;

struct TcLayout {
  int cp, hp, op, kp;  // C, H and O padded to 16, and the widest of them
  int warps, fixcap;   // of the block; fix-up entries a warp
  size_t w0, wh, wo, b0, bh, bo, wmax, buf, fix, masks, bytes;
};

inline TcLayout tc_layout(int C, int H, int L1, int O, bool masks) {
  TcLayout t;
  t.warps = masks ? kBwdTcWarps : kFwdTcWarps;
  t.fixcap = masks ? kBwdFixCap : kFwdFixCap;
  t.cp = pad16(C);
  t.hp = pad16(H);
  t.op = pad16(O);
  t.kp = t.cp > t.hp ? t.cp : t.hp;
  t.kp = t.kp > t.op ? t.kp : t.op;
  const size_t ldc = t.cp + kSkew, ldh = t.hp + kSkew;
  t.w0 = 0;
  t.wh = t.w0 + 2 * (size_t)t.hp * ldc;
  t.wo = t.wh + 2 * (size_t)L1 * t.hp * ldh;
  t.b0 = t.wo + 2 * (size_t)t.op * ldh;
  t.bh = t.b0 + 4 * (size_t)t.hp;
  t.bo = t.bh + 4 * (size_t)L1 * t.hp;
  t.wmax = t.bo + 4 * (size_t)t.op;
  t.buf = (t.wmax + 8 * (size_t)(L1 + 2) + 15) / 16 * 16;
  t.fix = t.buf + 2 * (size_t)t.warps * 16 * (t.kp + kSkew);
  t.masks = t.fix + 12 * (size_t)t.warps * t.fixcap + 16 * (size_t)t.warps;
  t.bytes = t.masks + (masks ? 4 * (size_t)(L1 + 1) * t.warps * 32 : 0);
  return t;
}

inline bool tc_takes(int C, int H, int L1, int O, bool masks) {
  return C >= 1 && H >= 1 && O >= 1 && L1 >= 0 && C <= kTcMaxWidth && H <= kTcMaxWidth &&
         O <= kTcMaxWidth && tc_layout(C, H, L1, O, masks).bytes <= (size_t)kMaxSmem;
}

// ---- f32-FMA path (csrc/mlp_chain_bf16_fma.cuh)

constexpr int kTN = 128;  // output columns per pass
constexpr int kKC = 32;   // reduction features per staged chunk
constexpr int kLdb = kTN + 4;
constexpr size_t kStageBytes = (size_t)kKC * kLdb * sizeof(float);
constexpr int kFmaBwdRM = 4;  // the backward's rows kernel: 32-row tiles

inline size_t fma_fwd_smem(int rm, int kpad) {
  return 2 * (size_t)kpad * (8 * rm + 4) * sizeof(float) + kStageBytes;
}

// rows a thread of the forward (64-row tiles when they fit and at least two
// a SM fill the card, else 32); 0: too wide
inline int fma_fwd_rm(int M, int C, int H) {
  const int kpad = C > H ? C : H;
  if (fma_fwd_smem(8, kpad) <= (size_t)kMaxSmem && cdiv(M, 64) >= 2 * 132) return 8;
  return fma_fwd_smem(4, kpad) <= (size_t)kMaxSmem ? 4 : 0;
}

inline size_t fma_bwd_smem(int C, int H, int L1, int O) {
  int kpad = C > H ? C : H;
  kpad = kpad > O ? kpad : O;
  constexpr int TM = 8 * kFmaBwdRM;
  return 3 * (size_t)kpad * (TM + 4) * sizeof(float) + kStageBytes +
         ((size_t)(L1 + 1) * H * TM + 15) / 16 * 16;
}

// ---- the forward (K2-bf16)

struct FwdPlan {
  int path;
  size_t smem;  // dynamic shared memory of a block
  int rm;       // FMA path: rows a thread
  TcLayout tc;  // tensor-core path
};

inline FwdPlan fwd_plan(int M, int C, int H, int L1, int O) {
  FwdPlan p;
  p.tc = tc_layout(C, H, L1, O, false);
  p.rm = 0;
  if (tc_takes(C, H, L1, O, false)) {
    p.path = kPathTensorCores;
    p.smem = p.tc.bytes;
    return p;
  }
  p.rm = fma_fwd_rm(M, C, H);
  p.path = p.rm ? kPathFma : kPathRefused;
  p.smem = p.rm ? fma_fwd_smem(p.rm, C > H ? C : H) : 0;
  return p;
}

// ---- the backward (K3-bf16): a rows kernel, the weight gradients over
// slices of rows, and their ordered reduction

constexpr int kWT = 64;  // wgrad: a 64 (n) x 64 (k) tile of one layer's dW
constexpr int kWR = 32;  // wgrad: rows per staged chunk
constexpr int kMaxSlices = 64;
constexpr int kMinSliceRows = 128;
constexpr int kTargetBlocks = 4 * 132;

// (n, k) of the dW that wgrad layer j computes: j = 0 dw0 [H, C]; 1..L1
// dwh[j-1] [H, H]; L1 + 1 dwout [O, H]
inline void wgrad_dims(int j, int C, int H, int L1, int O, int* n, int* k) {
  *n = j <= L1 ? H : O;
  *k = j == 0 ? C : H;
}

inline size_t n_grads(int C, int H, int L1, int O) {
  return (size_t)H * C + H + (size_t)L1 * H * H + (size_t)L1 * H + (size_t)O * H + O;
}

struct BwdPlan {
  int path;
  size_t smem;  // the rows kernel's dynamic shared memory
  int ldh;      // row stride of the a_l and p_l scratch: hp (tensor cores) or H
  TcLayout tc;
  int n_wtiles, slices, slice_rows;
  size_t n_grads;
  size_t acts, gpre, part, total;  // scratch offsets and size, in bytes
};

inline BwdPlan bwd_plan(int M, int C, int H, int L1, int O) {
  BwdPlan p;
  p.tc = tc_layout(C, H, L1, O, true);
  if (M >= 1 && tc_takes(C, H, L1, O, true)) {
    p.path = kPathTensorCores;
    p.smem = p.tc.bytes;
    p.ldh = p.tc.hp;
  } else {
    p.smem = fma_bwd_smem(C, H, L1, O);
    p.path = M >= 1 && p.smem <= (size_t)kMaxSmem ? kPathFma : kPathRefused;
    p.ldh = H;
  }
  p.n_wtiles = 0;
  for (int j = 0; j <= L1 + 1; ++j) {
    int n, k;
    wgrad_dims(j, C, H, L1, O, &n, &k);
    p.n_wtiles += cdiv(n, kWT) * cdiv(k, kWT);
  }
  const int m = M > 1 ? M : 1;
  int want = cdiv(kTargetBlocks, p.n_wtiles);
  want = want < 1 ? 1 : (want > kMaxSlices ? kMaxSlices : want);
  p.slice_rows = cdiv(cdiv(m, want), kWR) * kWR;
  p.slice_rows = p.slice_rows > kMinSliceRows ? p.slice_rows : kMinSliceRows;
  p.slices = cdiv(m, p.slice_rows);
  p.n_grads = n_grads(C, H, L1, O);
  const size_t act_bytes = (size_t)(L1 + 1) * M * p.ldh * 2;
  p.acts = 0;
  p.gpre = align256(act_bytes);
  p.part = p.gpre + align256(act_bytes);
  p.total = p.part + (size_t)p.slices * p.n_grads * sizeof(float);
  return p;
}

}  // namespace npf_bf16
