"""The port's elastic runtime (``repro_torch.runtime.elastic``) against
the reference's (``repro.runtime.elastic``): the reference's own tests
(``tests/test_substrate.py``) on the port, with a mesh of rows that repeat
one device as those tests fake theirs; the port's ``ElasticTrainer`` log
and final state against the reference's for the same failure events; and
``ElasticTrainer`` over ``make_train_step`` on the CPU (qwen2-moe-a2.7b's
smoke config, f32): the restored state equal to the saved one bit for
bit, and the losses after the rewind equal to an uninterrupted run's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.runtime import elastic as je
from repro_torch import checkpoint as tck
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataPipeline, batch_to_device
from repro_torch.models.model import init_params
from repro_torch.optim import OptConfig, init_opt_state, tree_leaves
from repro_torch.runtime import elastic as te
from repro_torch.runtime.steps import make_train_step


def test_surviving_mesh_rectangular_power_of_two():
    mesh = te.make_mesh((8, 1), device="cpu")        # fake 8 x 1 mesh rows
    m2 = te.surviving_mesh(mesh, failed_rows=[3])
    assert np.asarray(m2.devices).shape == (4, 1)    # 7 survivors -> 4 (pow2)
    assert m2.axis_names == ("data", "model") and m2.shape == {"data": 4, "model": 1}
    with pytest.raises(RuntimeError):
        te.surviving_mesh(te.make_mesh((2, 1), device="cpu"), [0, 1])


def test_rebalance_bounds_cover_batch():
    for n_rows in (3, 4, 7):
        spans = [te.rebalance_bounds(26, n_rows, r) for r in range(n_rows)]
        assert spans == [je.rebalance_bounds(26, n_rows, r) for r in range(n_rows)]
        assert spans[0][0] == 0 and spans[-1][1] == 26
        for (a, b), (c, d) in zip(spans, spans[1:]):
            assert b == c


@pytest.mark.parametrize("rows, failures", [
    (4, [(12, [1])]),                      # the reference's test: 3 survivors -> 2
    (8, [(7, [0, 5]), (13, [1])]),         # two events; rewinds to 5, then to 10
])
def test_elastic_trainer_matches_reference(tmp_path, rows, failures):
    """The reference's test loop on both packages: the same log, the same
    final state and mesh shape, checkpoints every 5 steps, 20 steps."""
    def j_step_fn(mesh):
        @jax.jit
        def step(state, batch):
            return {"w": state["w"] + batch.mean(), "n": state["n"] + 1}
        return step

    jtr = je.ElasticTrainer(j_step_fn, lambda m: {"w": jnp.zeros(()),
                                                  "n": jnp.zeros((), jnp.int32)},
                            str(tmp_path / "ref"), ckpt_every=5)
    jstate, jmesh = jtr.run(JMesh(np.array(jax.devices() * rows).reshape(rows, 1),
                                  ("data", "model")), 20, lambda s, m: jnp.ones((4,)),
                            failures=[je.FailureEvent(s, r) for s, r in failures])

    ttr = te.ElasticTrainer(
        lambda mesh: lambda state, batch: {"w": state["w"] + batch.mean(), "n": state["n"] + 1},
        lambda m: {"w": torch.zeros(()), "n": torch.zeros((), dtype=torch.int32)},
        str(tmp_path / "port"), ckpt_every=5)
    tstate, tmesh = ttr.run(te.make_mesh((rows, 1), device="cpu"), 20,
                            lambda s, m: torch.ones(4),
                            failures=[te.FailureEvent(s, r) for s, r in failures])
    assert ttr.log == jtr.log
    assert any(e.startswith("shrunk") for e in ttr.log) and any(e.startswith("ckpt")
                                                              for e in ttr.log)
    assert np.asarray(tmesh.devices).shape == np.asarray(jmesh.devices).shape
    assert tstate["n"].item() == int(jstate["n"]) == 20
    assert tstate["w"].item() == float(jstate["w"])
    assert tstate["n"].dtype == torch.int32 and tstate["w"].dtype == torch.float32


def test_elastic_trainer_resumes_after_a_crash(tmp_path):
    """A second trainer on the same directory resumes from its last commit."""
    def make(log_to):
        return te.ElasticTrainer(lambda m: lambda s, b: {"n": s["n"] + 1},
                                 lambda m: {"n": torch.zeros((), dtype=torch.int32)},
                                 str(tmp_path), ckpt_every=4, log=log_to)
    first, second = [], []
    make(first).run(te.make_mesh((2, 1), device="cpu"), 10, lambda s, m: None)
    state, _ = make(second).run(te.make_mesh((2, 1), device="cpu"), 14, lambda s, m: None)
    assert first == ["ckpt@4", "ckpt@8"] and second == ["resumed@8", "ckpt@12"]
    assert state["n"].item() == 14


def test_elastic_train_step_restores_bit_for_bit(tmp_path):
    """``ElasticTrainer`` over ``make_train_step`` (f32 qwen2-moe smoke, 2 x
    1 grid, checkpoints every 3 of 8 steps, a failure at step 5 that rewinds
    to 3): every restored leaf equals the saved one; the losses after the
    rewind equal an uninterrupted run's (the CPU is deterministic)."""
    cfg = get_smoke_config("qwen2-moe-a2.7b").replace(dtype="float32")
    pipe = DataPipeline(cfg.vocab_size, 16, 2, seed=0)
    losses, loads = [], []

    def make_step(mesh):
        step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=2), device="cpu")

        def fn(state, batch):
            params, opt, metrics = step(state["params"], state["opt"], batch)
            losses.append(metrics["loss"].item())
            return {"params": params, "opt": opt}
        return fn

    def init_state(mesh):
        params = init_params(cfg, seed=1, device="cpu")
        return {"params": params, "opt": init_opt_state(params)}

    class Recording(te.ElasticTrainer):
        @staticmethod
        def _load(template, tree, mesh):
            out = te.ElasticTrainer._load(template, tree, mesh)
            loads.append([t.clone() for t in tree_leaves(out)])    # steps update in place
            return out

    def batch_fn(step, mesh):
        return batch_to_device(pipe.batch(step), "cpu")

    tr = Recording(make_step, init_state, str(tmp_path / "a"), ckpt_every=3)
    state, mesh = tr.run(te.make_mesh((2, 1), device="cpu"), 8, batch_fn,
                         failures=[te.FailureEvent(5, [1])])
    assert tr.log == ["ckpt@3", "shrunk_to_(1, 1)@3", "ckpt@6"]
    saved, _, _ = tck.restore(str(tmp_path / "a"), step=3, device="cpu")
    assert len(loads) == 1
    for a, b in zip(loads[0], tree_leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = losses[:]
    losses.clear()
    Recording(make_step, init_state, str(tmp_path / "b"), ckpt_every=3).run(
        te.make_mesh((2, 1), device="cpu"), 8, batch_fn)
    assert len(resumed) == 10
    assert resumed[5:] == losses[3:]          # steps 3..7 again, from the restored state
    assert resumed[:5] == losses[:5]


def test_load_refuses_a_checkpoint_of_another_tree():
    template = {"params": {"w": torch.zeros(2)}, "count": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError):
        te.ElasticTrainer._load(template, {"params": {"v": torch.ones(2)},
                                           "count": torch.ones((), dtype=torch.int32)}, None)
    out = te.ElasticTrainer._load(template, {"params": {"w": torch.ones(2, dtype=torch.float64)},
                                             "count": torch.ones((), dtype=torch.int64)}, None)
    assert out["params"]["w"].dtype == torch.float32 and out["count"].dtype == torch.int32
