"""The sharded train, prefill and decode steps of the moe, hybrid, ssm, vlm
and audio families on a real 4-process gloo world, a (2, 2) CPU mesh: each
family's smoke config in f32 under ``DEFAULT_RULES`` (chameleon also under
``SEQ_PARALLEL_RULES``, deepseek-moe also at 16 routed experts, which the
rules shard over "model"), and qwen2.5's with 5 q heads, which the model
axis does not divide (ROADMAP.md §3 fault 10), equals the ``mesh=None``
step within 1e-5 relative.

- Train: the loss, the gradient norm and the MoE losses; the first and
  second moments after the step, leaf by leaf (each is the gradient, scaled
  or squared, so this holds every gradient); the updated parameters and
  master weights as one vector each.  Not leaf by leaf: AdamW divides each
  gradient entry by its own magnitude (eps 1e-8), so an entry of a bias
  initialised to zero whose gradient is some 1e-9, a sum that cancels,
  moves by a share of the learning rate that its last digits set (qwen2-moe's
  ``bk``: gradient entries 6.0e-9 and 6.8e-9, moments within 1.1e-6, the
  leaf after the step 3.1e-3 apart).  ``tests/torch_train_parity.py`` meets
  the same effect against the reference.
- Prefill: the last logits and the cache (the audio family's: the encoder
  pass and the cross-attention K/V at ragged ``enc_lens``).
- Decode: four steps at ragged positions and the cache after them.

One spawn runs every case (``tests/torch_family_sharded_parity.py``); a
``FileStore`` under ``tmp_path`` needs no port."""
import json

import pytest
import torch.multiprocessing as mp

import torch_family_sharded_parity as parity

TOL = 1e-5
CHECKS = {"train": ("train_loss", "train_grad_norm", "train_aux", "train_moments",
                    "train_params", "train_master"),
          "prefill": ("prefill_logits", "prefill_cache"),
          "decode": ("decode_logits", "decode_cache")}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    out = d / "out.json"
    mp.spawn(parity.run, args=(4, str(d / "store"), str(out)), nprocs=4)
    return json.loads(out.read_text())


@pytest.mark.parametrize("step", list(CHECKS))
@pytest.mark.parametrize("case", list(parity.CASES))
def test_sharded_step_equals_unsharded(results, case, step):
    rec = results[case]
    for key in CHECKS[step]:
        assert rec[key] <= TOL, (key, rec[key])
    if step == "train":
        assert rec["train_drop_frac_equal"]


@pytest.mark.parametrize("case", ["qwen2-moe", "deepseek-moe-ep16"])
def test_moe_dispatch_collectives(results, case):
    """The dispatch all-gathers each token shard's expert counts over
    "data"; the slot buffer is a sum over "data" and the combine one over
    "model" (all-reduces), with experts held whole (qwen2-moe's 6) or
    sharded over "model" (16)."""
    seen = {tuple(c) for c in results[case]["train_collectives"]}
    assert {("all_gather_into_tensor", "data"), ("all_reduce", "data"),
            ("all_reduce", "model")} <= seen, seen


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-moe-16b", "jamba-v0.1-52b",
                                  "xlstm-125m", "chameleon-34b", "seamless-m4t-large-v2"])
def test_a_1x1_mesh_equals_one_device_bit_for_bit(arch):
    """On a mesh of one rank (a gloo world of one) each family's train,
    prefill and decode steps give the one-device steps' outputs to the bit
    (bf16 smoke configs): the MoE decode keeps its grouped route there."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import launcher_mesh

    cfg = get_smoke_config(arch)
    want = parity.flat(parity.step_outputs(cfg, None))
    with launcher_mesh(1, 1, "cpu") as mesh:
        got = parity.flat(parity.step_outputs(cfg, mesh))
    assert len(got) == len(want)
    assert [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)] == []
