"""What surrounds the hand-written kernels and can be checked without a card:
the build's naming (every source and header edit rebuilds), the C entry
points' bindings, the bfloat16 chain kernels' launch plans (host C++ in
csrc/mlp_chain_bf16_plan.h, built here with the host compiler), the scorer's
summary metrics, the kernels' bounds (`kernel_measure`) and the kernel A/B
tool's ptxas parsing. The kernels themselves are held against their plain
versions on the H100 by `chip_smoke.py`; the float32 kernels' tile, grid and
scratch planning is C code inside their launchers (`make_plan` in
csrc/mlp_chain_bwd.cu, the launcher of csrc/setconv_fwd.cu) and runs only
there."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from npf_gwwaveform_tpu_torch import _build
from npf_gwwaveform_tpu_torch.kernel_ab import k2_errs, ptxas_report
from npf_gwwaveform_tpu_torch.kernel_measure import bound, k1_bound, k2_bound, k3_bound
from npf_gwwaveform_tpu_torch.models.convnp import ConvCNP
from npf_gwwaveform_tpu_torch.ops.kernels import KERNELS, hand_kernel_id
from npf_gwwaveform_tpu_torch.score import eval_splitter, score_batch, summary_metrics
from npf_gwwaveform_tpu_torch.data.gw import GWParameterSpace, GWWaveformGenerator

torch.set_num_threads(1)


def test_sources_and_header_are_in_the_build():
    names = {os.path.basename(p) for p in _build.sources()}
    assert {"setconv_fwd.cu", "mlp_chain_fwd.cu", "mlp_chain_bwd.cu", "mlp_chain_fwd_bf16.cu",
            "mlp_chain_bwd_bf16.cu", "mlp_chain_bf16_plan.cu"} <= names
    headers = {os.path.basename(p) for p in _build.headers()}
    assert {"tile_fma.cuh", "mlp_chain_bf16.cuh", "mlp_chain_bf16_fma.cuh",
            "mlp_chain_bf16_plan.h"} <= headers


def test_kernel_map_names_every_global_function_of_the_sources():
    """`ops.kernels.KERNELS` (what the profilers and chip_smoke.py count a
    trace's kernels by) names each `__global__` function of csrc/*.cu once,
    and a trace's demangled names map back to their wrapper's id."""
    found = set()
    for path in _build.sources():
        with open(path) as f:
            found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                    f.read()))
    named = [fn for k in KERNELS.values() for fn in k.marks + k.helpers]
    assert len(named) == len(set(named)) and set(named) == found
    assert hand_kernel_id("void mlp_chain_bwd_bf16_rows_tc<2>(__nv_bfloat16 const*, int)") == "K3-bf16"
    assert hand_kernel_id("mlp_chain_bwd_rows(float const*, float const*, int)") == "K3"
    assert hand_kernel_id("void mlp_chain_bwd_wgrad(float const*)", marks_only=True) is None
    assert hand_kernel_id("void at::native::elementwise_kernel<128, 4>(int)") is None


def test_bf16_plan_queries_are_bound():
    """The plan queries the wrappers and chip_smoke.py ask: (M, C, H, L1, O)
    ints; the path queries return an int, the size queries a long long."""
    for name in ("npf_mlp_chain_fwd_bf16_path", "npf_mlp_chain_bwd_bf16_path",
                 "npf_mlp_chain_bwd_bf16_scratch"):
        assert _build._SIGNATURES[name] == [ctypes.c_int] * 5
    assert _build._SIGNATURES["npf_mlp_chain_fwd_bf16_smem"] == [ctypes.c_int] * 4
    assert "npf_mlp_chain_fwd_bf16_path" not in _build._RESTYPES
    assert _build._RESTYPES["npf_mlp_chain_bwd_bf16_scratch"] is ctypes.c_longlong


@pytest.mark.parametrize("edited", ["tile_fma.cuh", "setconv_fwd.cu", "mlp_chain_bf16_plan.h"])
def test_library_name_follows_every_source_and_header(tmp_path, edited):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    before = _build.library_path(str(csrc))
    assert before == _build.library_path(_build.CSRC_DIR)
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = _build.library_path(str(csrc))
    assert after != before and os.path.dirname(after) == _build.BUILD_DIR


def test_summary_metrics_are_reproduce_gws():
    rng = np.random.default_rng(0)
    ll = rng.normal(890, 20, 300).astype(np.float32)
    mm = rng.exponential(0.02, 300).astype(np.float32)
    mz = mm + rng.uniform(0, 1e-3, 300).astype(np.float32)
    got = summary_metrics(ll, mm, mz)
    assert got["test_ll_per_wf"] == float(ll.mean()) == -got["test_nll_per_wf"]
    assert got["mismatch_median"] == float(np.median(mm))
    assert got["mismatch_mean"] == float(mm.mean())
    assert got["mismatch_p90"] == float(np.percentile(mm, 90))
    assert got["mismatch_p99"] == float(np.percentile(mm, 99))
    assert got["frac_below_0.03"] == float((mm < 0.03).mean())
    assert got["frac_below_0.1"] == float((mm < 0.1).mean())
    assert got["mismatch_zdraw_median"] == float(np.median(mz))
    assert got["mismatch_zdraw_p90"] == float(np.percentile(mz, 90))
    assert got["zdraw_frac_below_0.03"] == float((mz < 0.03).mean())


def test_score_batch_per_draw_mismatch_equals_the_mixtures_for_one_draw():
    torch.manual_seed(0)
    model = ConvCNP(r_dim=8, density_induced=8, cnn_n_blocks=1, cnn_kernel_size=3,
                    cond_dim=4).eval()
    space = GWParameterSpace()
    gen = GWWaveformGenerator(duration=1.0, sample_rate=1024.0)
    g = torch.Generator().manual_seed(3)
    theta = space.sample(5, g)
    with torch.no_grad():
        ll, mm, mz, out = score_batch(model, eval_splitter(64), g, theta, gen, space)
    assert out.p_yCc.loc.shape[0] == 1
    assert ll.shape == mm.shape == mz.shape == (5,)
    torch.testing.assert_close(mz, mm, rtol=0, atol=0)


def test_bound_is_the_larger_of_bytes_and_operations():
    t, by = bound(3.35e9, 1.0)  # 3.35 GB at 3.35 TB/s: 1 ms
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = bound(1.0, 67e9)  # 67 GFLOP at 67 TFLOP/s: 1 ms
    assert by == "operations" and t == pytest.approx(1.0)


def test_k3_bound_at_the_training_shape():
    """The forward recompute and the input and weight gradients of the
    decoder chain at M = 8,192: 3.23 GFLOP, ~0.0482 ms at 67 TFLOP/s."""
    M, C, H, L1, O = 8192, 128, 128, 3, 2
    args = (torch.zeros(M, C), torch.zeros(M, O), torch.zeros(H, C), torch.zeros(H),
            torch.zeros(L1, H, H), torch.zeros(L1, H), torch.zeros(O, H))
    t, by = k3_bound(*args)
    assert by == "operations" and t == pytest.approx(
        (2 * M * (C * H + L1 * H * H) + 4 * M * (H * C + L1 * H * H + O * H)) / 67e9)


@pytest.mark.parametrize("M,expected_ms", [(8192, 0.0161), (65536, 0.1287)])
def test_k2_bound_at_the_decoder_shapes(M, expected_ms):
    """The decoder chain (C = H = 128, L1 = 3, O = 2) is 65,792 multiply-adds
    a row: 1.08 GFLOP at the training shape, 8.62 at the scoring shape, set by
    operations at 67 TFLOP/s (its 34 MB of x and out take 0.010 ms)."""
    C, H, L1, O = 128, 128, 3, 2
    args = (torch.zeros(M, C), torch.zeros(H, C), torch.zeros(H), torch.zeros(L1, H, H),
            torch.zeros(L1, H), torch.zeros(O, H), torch.zeros(O))
    t, by = k2_bound(*args)
    assert by == "operations" and t == pytest.approx(
        2 * M * (C * H + L1 * H * H + H * O) / 67e9)
    assert t == pytest.approx(expected_ms, abs=5e-5)
    t_no_bias, _ = k2_bound(args[0], args[1], None, args[3], None, args[5], None)
    assert t_no_bias == t


def test_k2_ab_errors_are_absolute_and_of_the_max_magnitude():
    ref = torch.tensor([[1.0, -4.0], [2.0, 0.5]])
    out = ref.clone()
    out[1, 0] += 1e-3
    errs = k2_errs((out,), (ref,))
    assert errs["max_abs_err"] == pytest.approx(1e-3, rel=1e-3)
    assert errs["rel_err"] == pytest.approx(1e-3 / 4.0, rel=1e-3)


def test_load_leaves_entry_points_an_earlier_build_lacks(monkeypatch):
    """An earlier commit's library (kernel_ab's old build) may lack an entry
    point of the table: it loads, with the others' signatures set."""
    class Fn:
        pass

    class Lib:
        def __init__(self, path):
            for name in _build._SIGNATURES:
                if name != "npf_mlp_chain_fwd_smem":
                    setattr(self, name, Fn())

    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    handle = _build.load("old.so")
    assert not hasattr(handle, "npf_mlp_chain_fwd_smem")
    assert handle.npf_mlp_chain_bwd_scratch.restype is _build.ctypes.c_longlong
    assert handle.npf_mlp_chain_fwd.argtypes == _build._SIGNATURES["npf_mlp_chain_fwd"]


def test_k1_bound_counts_only_real_keys():
    B, K, Q, C = 2, 384, 256, 128
    keys, queries, values = torch.zeros(B, K), torch.zeros(B, Q), torch.zeros(B, K, C)
    mask = torch.zeros(B, K)
    mask[0] = 1.0
    half, _ = k1_bound(keys, queries, values, mask)
    mask[1] = 1.0
    full, by = k1_bound(keys, queries, values, mask)
    assert by == "operations" and full == pytest.approx(2 * half)
    assert full == pytest.approx(B * K * Q * (2 * C + 10) / 67e9)


def test_ptxas_report_reads_registers_and_static_shared_memory():
    log = ("ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'\n"
           "ptxas info    : Used 127 registers, used 1 barriers, 25600 bytes smem\n")
    assert ptxas_report(log) == [dict(kernel="_Zk1", registers=168, smem_bytes=0),
                                 dict(kernel="_Zk2", registers=127, smem_bytes=25600)]


@pytest.fixture(scope="module")
def bf16_plan(tmp_path_factory):
    """csrc/mlp_chain_bf16_plan.cu, the bf16 kernels' C plan queries, built
    with the host C++ compiler and bound as `_build.load` binds the kernel
    library (the kernels' entry points are absent from it)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = str(tmp_path_factory.mktemp("plan") / "libplan.so")
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC", "-o", out,
                    os.path.join(_build.CSRC_DIR, "mlp_chain_bf16_plan.cu")], check=True)
    return _build.load(out)


# (M, C, H, L1, O) of the chip's K2-bf16/K3-bf16 cases: the decoder at the
# scoring and training shapes (one channel, and the frequency-domain runs'
# two: O = 4), then K2's edge cases (chip_smoke.py, K2_CASES)
_DECODER = [(65536, 128, 128, 3, 2), (8192, 128, 128, 3, 2), (65536, 128, 128, 3, 4),
            (8192, 128, 128, 3, 4)]
_K2_EDGES = [(4099, 37, 64, 2, 5), (1000, 128, 128, 0, 3), (1500, 200, 96, 1, 2),
             (3001, 200, 256, 2, 3), (3001, 200, 320, 2, 3), (2049, 128, 128, 1, 8),
             (2049, 128, 128, 1, 9), (20001, 64, 96, 2, 130), (20001, 96, 144, 2, 3)]
_REFUSED = [(300, 800, 700, 1, 2), (300, 1600, 1600, 1, 2)]


def _parent_takes_fwd(M, C, H, L1, O):
    """1525b57's K2-bf16 plan: 32-row tiles of two activation buffers of
    max(C, H) features and a staged weight chunk within 232,448 bytes."""
    return 2 * max(C, H) * 36 * 4 + 32 * 132 * 4 <= 232448


def _parent_takes_bwd(M, C, H, L1, O):
    """1525b57's K3-bf16 plan: three activation buffers, a staged chunk and
    the ReLU masks of a 32-row tile within 232,448 bytes."""
    kpad = max(C, H, O)
    masks = -(-(L1 + 1) * H * 32 // 16) * 16
    return M >= 1 and 3 * kpad * 36 * 4 + 32 * 132 * 4 + masks <= 232448


def test_bf16_plan_sends_the_decoder_to_the_tensor_cores(bf16_plan):
    for shape in _DECODER:
        assert bf16_plan.npf_mlp_chain_fwd_bf16_path(*shape) == 1
        assert bf16_plan.npf_mlp_chain_bwd_bf16_path(*shape) == 1
        M, C, H, L1, O = shape
        # the a_l and p_l scratch rows padded to 16 features, and the slices' sums
        assert bf16_plan.npf_mlp_chain_bwd_bf16_scratch(*shape) >= 2 * (L1 + 1) * M * H * 2
    for shape in _K2_EDGES:
        M, C, H, L1, O = shape
        tc = max(C, H, O) <= 128
        assert bf16_plan.npf_mlp_chain_fwd_bf16_path(*shape) == (1 if tc else 2)
        assert bf16_plan.npf_mlp_chain_bwd_bf16_path(*shape) == (1 if tc else 2)
        assert bf16_plan.npf_mlp_chain_fwd_bf16_smem(M, C, H, O) > 0
    for shape in _REFUSED:
        M, C, H, L1, O = shape
        assert bf16_plan.npf_mlp_chain_fwd_bf16_path(*shape) == -1
        assert bf16_plan.npf_mlp_chain_fwd_bf16_smem(M, C, H, O) == -1


def test_bf16_plan_refuses_nothing_the_parent_took(bf16_plan):
    """Over widths on both sides of the tensor-core kernels' 128 and of the
    FMA kernels' shared memory, a call is refused exactly where 1525b57's
    plan refused it, and only widths up to 128 take the tensor cores."""
    for M in (1, 5000):
        for C in (1, 37, 128, 129, 200, 748, 749):
            for H in (16, 64, 128, 144, 320, 700):
                for L1 in (0, 3, 6):
                    for O in (1, 2, 16, 130):
                        shape = (M, C, H, L1, O)
                        fwd = bf16_plan.npf_mlp_chain_fwd_bf16_path(*shape)
                        bwd = bf16_plan.npf_mlp_chain_bwd_bf16_path(*shape)
                        assert (fwd != -1) == _parent_takes_fwd(*shape), shape
                        assert (bwd != -1) == _parent_takes_bwd(*shape), shape
                        assert (bf16_plan.npf_mlp_chain_bwd_bf16_scratch(*shape) >= 0) == (
                            bwd != -1), shape
                        if 1 in (fwd, bwd):
                            assert max(C, H, O) <= 128, shape
