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
    "void repro_torch::flash_fwd_wgmma_kernel<64>(CUtensorMap_st, CUtensorMap_st, "
    "CUtensorMap_st, __nv_bfloat16*, int, int, int, int, int, int, float)": "flash_attention",
    "void repro_torch::decode_split_bf16_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
    "__nv_bfloat16 const*, int const*, float*, float*, int, int, int, int, int, float)":
        "decode_attention",
    "void repro_torch::decode_combine_bf16_kernel<64>(float const*, float const*, int const*, "
    "__nv_bfloat16*, int, int, int, int, int, int)": "decode_attention",
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


def _op(cat, name, tid, ts, dur=1.0, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur, "args": args}


def test_train_step_classes():
    """Kernels of an LM train step: the flash forward by name wherever it
    runs; kernels launched inside a marked region, or inside a backward node
    whose forward op ran in the CE region, take the region's class; then
    cuBLAS by name; the rest is other."""
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
    events = [
        _op("user_annotation", "chunked_ce", 1, 0, 10),
        _op("cpu_op", "aten::logsumexp", 1, 2, 1, **{"Sequence number": 5}),
        _op("cpu_op", "aten::mm", 1, 20, 1, **{"Sequence number": 6}),         # outside: a layer
        _op("cpu_op", "autograd::engine::evaluate_function: LogsumexpBackward0", 2, 100, 10,
            **{"Sequence number": 5, "Fwd thread id": 1}),
        _op("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 2, 150, 10,
            **{"Sequence number": 6, "Fwd thread id": 1}),
        _op("user_annotation", "flash_attention_bwd", 2, 200, 100),
        _op("user_annotation", "adamw", 1, 400, 100),
    ]
    launches = [(1, 3, 10), (1, 21, 11), (2, 105, 12), (2, 155, 13), (2, 250, 14), (1, 450, 15),
                (2, 350, 16), (2, 260, 17)]
    names = ["void at::native::reduce_kernel<...>", gemm, "elementwise", gemm, gemm,
             "multi_tensor_apply", "elementwise",
             "_ZN11repro_torch22flash_fwd_wgmma_kernelE14CUtensorMap_st"]
    kernels = []
    for (tid, ts, corr), name in zip(launches, names):
        events.append(_op("cuda_runtime", "cudaLaunchKernel", tid, ts, correlation=corr))
        kernels.append(_op("kernel", name, 7, 1000 + corr, correlation=corr))
    assert torch_profile.train_step_classes(events, kernels, fwd_tid=1) == [
        "chunked CE", "cuBLAS", "chunked CE", "cuBLAS", "attention backward", "AdamW", "other",
        "flash forward"]


def test_serve_step_classes():
    """Kernels of a serving step: those launched inside the MoE or Mamba
    scan regions take the region's class, even a cuBLAS product; the rest
    are filed by name."""
    gemm = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n"
    events = [_op("user_annotation", "moe", 1, 0, 10),
              _op("user_annotation", "mamba_scan", 1, 50, 10)]
    launches = [(1, 2, 10), (1, 5, 11), (1, 20, 12), (1, 55, 13), (1, 70, 14)]
    names = [gemm, "elementwise", gemm, "elementwise",
             "_ZN11repro_torch24decode_split_bf16_kernelEPK13__nv_bfloat16"]
    kernels = []
    for (tid, ts, corr), name in zip(launches, names):
        events.append(_op("cuda_runtime", "cudaLaunchKernel", tid, ts, correlation=corr))
        kernels.append(_op("kernel", name, 7, 1000 + corr, correlation=corr))
    assert torch_profile.serve_step_classes(events, kernels, fwd_tid=1) == [
        "MoE", "MoE", "matmul (cuBLAS)", "Mamba scan", "decode_attention"]


def test_region_spans_on_a_real_trace(tmp_path):
    """On a CPU trace of the port's loss and gradients, the CE's backward
    nodes are found through their sequence numbers."""
    import json
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tm
    from repro_torch.optim import tree_leaves

    cfg = get_smoke_config("llama3-8b").replace(dtype="float32", n_layers=1)
    params = tm.init_params(cfg, seed=0, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 24)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        total, _ = tm.loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
        torch.autograd.grad(total, tree_leaves(params))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    spans = torch_profile.region_spans(events, threading.get_native_id())
    nodes = [e["name"] for e in events if e.get("cat") == "cpu_op"
             and e["name"].startswith("autograd::engine::evaluate_function")
             and any(a == e["ts"] and c == "chunked CE" for _, a, _, c in spans)]
    assert any("Logsumexp" in n for n in nodes), nodes
    assert not any("Embedding" in n or "Index" in n for n in nodes), nodes
