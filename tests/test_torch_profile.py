"""``tools/torch_profile.py`` files each of the port's kernels under its own
class, by the names the profiler shows (mangled or demangled), and keeps
the flash kernel out of the cuBLAS class."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import torch_profile  # noqa: E402

NAMES = {
    "_ZN11repro_torch22flash_fwd_wgmma_kernelE14CUtensorMap_stS0_S0_P13__nv_bfloat16iiiiiif":
        "flash_attention",
    "repro_torch::flash_fwd_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
    "__nv_bfloat16*, int, int, int, int, int, int, float)": "flash_attention",
    "void repro_torch::flash_fwd_simt_kernel<float, 128>(float const*, float const*, "
    "float const*, float*, int, int, int, int, int, int, float)": "flash_attention",
    "void repro_torch::decode_split_kernel<__nv_bfloat16, 128>(...)": "decode_attention",
    "_ZN11repro_torch24decode_split_bf16_kernelEPK13__nv_bfloat16S2_S2_PKiPfS5_iiiiiif":
        "decode_attention",
    "repro_torch::decode_split_bf16_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "__nv_bfloat16 const*, int const*, float*, float*, int, int, int, int, int, float)":
        "decode_attention",
    "_ZN11repro_torch26decode_combine_bf16_kernelEPKfS1_PKiP13__nv_bfloat16iiiiii":
        "decode_attention",
    "repro_torch::decode_combine_bf16_kernel(float const*, float const*, int const*, "
    "__nv_bfloat16*, int, int, int, int, int, int)": "decode_attention",
    "void repro_torch::decode_split_f32_kernel<128>(float const*, float const*, float const*, "
    "int const*, float*, float*, int, int, int, int, int, float)": "decode_attention",
    "void repro_torch::decode_combine_f32_kernel<128>(float const*, float const*, int const*, "
    "float*, int, int, int, int, int, int)": "decode_attention",
    "void repro_torch::rmsnorm_kernel<__nv_bfloat16>(...)": "rmsnorm",
    "_ZN11repro_torch19rmsnorm_regs_kernelI13__nv_bfloat16S1_Li4EEEvPKT_PKT0_PS3_iifii":
        "rmsnorm",
    "void repro_torch::rmsnorm_regs_kernel<__nv_bfloat16, float, 8>(__nv_bfloat16 const*, "
    "float const*, __nv_bfloat16*, int, int, float, int, int)": "rmsnorm",
    "void repro_torch::rmsnorm_kernel<float, float>(float const*, float const*, float*, int, "
    "int, float, int)": "rmsnorm",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1":
        "matmul (cuBLAS)",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT": "matmul (cuBLAS)",
    "void at::native::vectorized_elementwise_kernel<4, ...>(...)": "other",
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_kernel_class(name):
    assert torch_profile.kernel_class(name) == NAMES[name]
