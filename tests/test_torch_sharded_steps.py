"""The sharded train, prefill and decode steps on a real 4-process gloo
world, a (2, 2) CPU mesh: the dense smoke config in f32 under
``DEFAULT_RULES``, ``SEQ_PARALLEL_RULES`` and ``FSDP_SP_RULES`` equals the
``mesh=None`` step within 1e-5 relative (loss, gradient norm, updated
parameters and master weights; prefill logits and cache; four decode steps
at ragged positions and the cache after them).  One spawn runs every case
(``tests/torch_sharded_parity.py``); a ``FileStore`` under ``tmp_path``
needs no port."""
import json

import pytest
import torch.multiprocessing as mp

import torch_sharded_parity as parity

TOL = 1e-5
CHECKS = {"train": ("train_loss", "train_grad_norm", "train_params", "train_master"),
          "prefill": ("prefill_logits", "prefill_cache"),
          "decode": ("decode_logits", "decode_cache")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    out = d / "out.json"
    mp.spawn(parity.run, args=(4, str(d / "store"), str(out)), nprocs=4)
    return json.loads(out.read_text())


@pytest.mark.parametrize("step", list(CHECKS))
@pytest.mark.parametrize("rules", parity.RULES)
def test_sharded_step_equals_unsharded(results, rules, step):
    rec = results[rules]
    for key in CHECKS[step]:
        assert rec[key] <= TOL, (key, rec[key])


@pytest.mark.parametrize("step", list(CHECKS))
def test_baseline_collectives(results, step):
    """FSDP weights are all-gathered over "data"; the row-parallel attention
    and MLP outputs are reduced over "model" (an all-reduce into the
    replicated residual; the train step's gradients also reduce-scatter)."""
    seen = {tuple(c) for c in results["baseline"][f"{step}_collectives"]}
    assert ("all_gather_into_tensor", "data") in seen, seen
    assert ("all_reduce", "model") in seen, seen
    if step == "train":
        assert ("reduce_scatter_tensor", "data") in seen, seen


def _launchers_equal_one_device(arch: str, capsys) -> None:
    """``--mesh-data 1 --mesh-model 1`` (the default) runs ``arch`` through
    the sharded steps in a world of one rank: the same tokens and losses as
    the one-device steps; the world is gone after."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch import serve, train
    from repro_torch.models.model import init_params
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.runtime.steps import make_decode_step, make_train_step

    logits = serve.main(["--arch", arch, "--batch", "2", "--gen", "3", "--device", "cpu"])
    cfg = get_smoke_config(arch)
    step, params = make_decode_step(cfg, 2, 4, "cpu"), init_params(cfg, 0, "cpu")
    cache, tok = step.init_cache(params), torch.zeros((2,), dtype=torch.int32)
    for i in range(3):
        ref, cache = step(params, cache, tok, torch.full((2,), i, dtype=torch.int32))
        tok = ref.argmax(dim=-1).to(torch.int32)
    assert torch.equal(logits, ref)
    metrics = train.main(["--arch", arch, "--steps", "2", "--batch", "2", "--seq", "16",
                          "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-4].startswith(f"arch={cfg.name} device=cpu "
                                                                 "mesh=1x1")
    tstep, params = make_train_step(cfg, OptConfig(), "cpu"), init_params(cfg, 0, "cpu")
    opt, pipe = init_opt_state(params), DataPipeline(cfg.vocab_size, 16, 2, seed=0, mode="markov")
    for s in range(2):
        b = {k: torch.as_tensor(v) for k, v in pipe.batch(s).items()}
        params, opt, m = tstep(params, opt, b)
    assert torch.equal(metrics["loss"], m["loss"])
    assert not dist.is_initialized()


def test_launchers_on_a_1x1_mesh(capsys):
    _launchers_equal_one_device("llama3-8b", capsys)


def test_launchers_refuse_a_mesh_the_world_does_not_have(capsys):
    """A mesh larger than the world raises, whatever the family; the moe
    family's launchers run on a 1 x 1 mesh as the dense family's do."""
    from repro_torch.launch import serve, train

    with pytest.raises(ValueError, match="needs a world of 4 ranks"):
        serve.main(["--arch", "llama3-8b", "--gen", "2", "--device", "cpu",
                    "--mesh-data", "2", "--mesh-model", "2"])
    with pytest.raises(ValueError, match="needs a world of 2 ranks"):
        train.main(["--arch", "qwen2-moe-a2.7b", "--steps", "1", "--device", "cpu",
                    "--mesh-model", "2"])
    _launchers_equal_one_device("qwen2-moe-a2.7b", capsys)
