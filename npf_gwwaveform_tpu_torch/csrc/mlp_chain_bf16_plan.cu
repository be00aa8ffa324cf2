// The C plan queries of the bfloat16 MLP-chain kernels, asked by the
// wrappers (ops/kernels/mlp_chain.py) before any launch. Host code only
// (csrc/mlp_chain_bf16_plan.h): nvcc builds it into the kernel library, and
// a host C++ compiler builds it alone for the CPU tests.

#include "mlp_chain_bf16_plan.h"

using namespace npf_bf16;

// -1 when K2-bf16 refuses the widths (nothing may be launched then); else
// the bytes of shared memory a block of its f32-FMA kernel takes, the path
// of the widths the tensor-core kernel does not take. L1 does not enter:
// the FMA kernel streams the hidden weights, and the tensor-core kernel
// hands every chain it cannot hold to it.
extern "C" long long npf_mlp_chain_fwd_bf16_smem(int M, int C, int H, int O) {
  (void)O;  // the output layer needs no shared memory of its own
  const int rm = fma_fwd_rm(M, C, H);
  return rm == 0 ? -1 : (long long)fma_fwd_smem(rm, C > H ? C : H);
}

// The kernel that K2-bf16 launches for these widths: 1 tensor cores, 2 f32
// FMA, -1 refused.
extern "C" int npf_mlp_chain_fwd_bf16_path(int M, int C, int H, int L1, int O) {
  return fwd_plan(M, C, H, L1, O).path;
}

// Bytes of scratch K3-bf16 takes; -1 when it refuses the widths.
extern "C" long long npf_mlp_chain_bwd_bf16_scratch(int M, int C, int H, int L1, int O) {
  const BwdPlan p = bwd_plan(M, C, H, L1, O);
  return p.path == kPathRefused ? -1 : (long long)p.total;
}

// The rows kernel that K3-bf16 launches for these widths: 1 tensor cores,
// 2 f32 FMA, -1 refused. The weight gradients take the tensor cores on
// both paths.
extern "C" int npf_mlp_chain_bwd_bf16_path(int M, int C, int H, int L1, int O) {
  return bwd_plan(M, C, H, L1, O).path;
}
