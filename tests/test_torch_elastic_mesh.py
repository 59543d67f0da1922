"""``ElasticTrainer`` on a ``DeviceMesh`` (``repro_torch.runtime.elastic``)
against the reference's loop (``repro/runtime/elastic.py``), on a real
4-process gloo world: a (4, 1) ``("data", "model")`` mesh of CPU ranks
under the sharded ``make_train_step`` of llama3-8b's smoke config in f32
(children in ``tests/torch_elastic_mesh_parity.py``; one spawn runs every
case, a ``FileStore`` under ``tmp_path`` needs no port).

- Row 1 failing at step 7 of 12 (checkpoints every 3): the survivors'
  log equals the reference's ``ElasticTrainer`` for the same events on its
  mesh of one repeated device, the survivors are ranks 0 and 2 and the
  others leave the loop; the restored DTensor leaves equal the saved ones
  bit for bit; the losses after the rewind are within 1e-5 relative of the
  uninterrupted run's (a 2-row mesh sums the batch in another order); each
  data row's local batch is its ``rebalance_bounds`` slice.
- Row 0 failing: rank 1 writes the checkpoints from then on.
- A crash: a second trainer on the same directory resumes.

The reference runs its loop with a step of a counter (no compile)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh as JMesh

import torch_elastic_mesh_parity as parity
from repro.runtime import elastic as je
from repro_torch.runtime import elastic as te

LOSS_TOL = 1e-5
WORLD = 4


def reference_log(tmp_path, case: str) -> list:
    """The reference's log for a case's steps and failure events."""
    steps, events = parity.CASES[case]
    tr = je.ElasticTrainer(lambda mesh: lambda state, batch: {"n": state["n"] + 1},
                           lambda mesh: {"n": jnp.zeros((), jnp.int32)},
                           str(tmp_path / f"ref-{case}"), ckpt_every=parity.EVERY)
    tr.run(JMesh(np.array(jax.devices() * WORLD).reshape(WORLD, 1), ("data", "model")), steps,
           lambda s, m: None, failures=[je.FailureEvent(s, rows) for s, rows in events])
    return tr.log


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    out = d / "out.json"
    mp.spawn(parity.run, args=(WORLD, str(d / "store"), str(d / "ckpt"), str(out)),
             nprocs=WORLD)
    return json.loads(out.read_text())


def _rel(a: list, b: list) -> float:
    assert len(a) == len(b) and a
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


@pytest.mark.parametrize("case, survivors", [("row1", [0, 2]), ("row0", [1, 2])])
def test_shrink_log_and_survivors_match_the_reference(ranks, tmp_path, case, survivors):
    ref = reference_log(tmp_path, case)
    assert any(e.startswith("shrunk_to_(2, 1)@") for e in ref)
    for r, rec in enumerate(ranks):
        c = rec[case]
        assert c["mesh"] == survivors, (r, c["mesh"])
        if r in survivors:
            assert not c["left"] and c["log"] == ref, (r, c["log"], ref)
        else:                   # built the new mesh, then left the loop
            assert c["left"] and "shrunk" not in " ".join(c["log"]), (r, c["log"])


@pytest.mark.parametrize("case", ["row1", "row0", "crash"])
def test_restored_dtensor_state_is_bit_for_bit_the_saved_one(ranks, case):
    for r, rec in enumerate(ranks):
        c = rec[case]
        if c["left"]:
            assert "restored_equal" not in c
            continue
        assert c["n_restored"] == 1 and c["restored_equal"], (r, c)
        # params, master, m and v as DTensors; the step count stays a plain tensor
        assert c["restored_dtensors"] == c["restored_leaves"] - 1 > 0
        assert c["dtypes"] == ["torch.float32", "torch.int32"]


def test_losses_after_the_rewind_match_the_uninterrupted_run(ranks):
    for r in (0, 2):
        whole, failed = ranks[r]["whole"]["losses"], ranks[r]["row1"]["losses"]
        assert len(whole) == 12 and len(failed) == 7 + 6
        assert failed[:7] == whole[:7]               # the same (4, 1) mesh before it
        assert _rel(failed[7:], whole[6:]) <= LOSS_TOL
    for r in (1, 2):
        whole, failed = ranks[r]["whole"]["losses"], ranks[r]["row0"]["losses"]
        assert len(failed) == 4 + 3 and failed[:4] == whole[:4]
        assert _rel(failed[4:], whole[3:6]) <= LOSS_TOL


def test_each_data_row_trains_on_its_rebalance_slice(ranks):
    """Before the shrink rows of 2 sequences, after it rows of 4."""
    for r, rec in enumerate(ranks):
        for case in parity.CASES:
            assert rec[case]["slices_ok"] and rec[case]["n_slices"] > 0, (r, case)


def test_row_0_failing_moves_the_checkpoint_writer(ranks):
    saves = {r: rec["row0"]["saves"] for r, rec in enumerate(ranks)}
    assert saves == {0: [["row0", 3]], 1: [["row0", 6]], 2: [], 3: []}, saves
    assert [rec["row0"]["writer"] for rec in ranks] == [1, 1, 1, 1]
    assert [rec["whole"]["saves"] for rec in ranks] == [
        [["whole", s] for s in (3, 6, 9, 12)], [], [], []]


def test_a_crashed_run_resumes_on_the_mesh(ranks):
    for r, rec in enumerate(ranks):
        c = rec["crash"]
        assert c["log"] == ["ckpt@3", "|", "resumed@3", "ckpt@6"], (r, c["log"])
        first, second = (c["losses"][:3], c["losses"][4:])
        whole = rec["whole"]["losses"]
        assert first == whole[:3] and _rel(second, whole[3:6]) <= LOSS_TOL


def test_all_rows_failing_raises_on_a_device_mesh(tmp_path):
    """A world of one: the reference's error when no row survives."""
    from repro_torch.launch.mesh import launcher_mesh

    tr = te.ElasticTrainer(lambda mesh: lambda s, b: {"n": s["n"] + 1},
                           lambda mesh: {"n": torch.zeros((), dtype=torch.int32)},
                           str(tmp_path), ckpt_every=2)
    with launcher_mesh(1, 1, "cpu") as mesh:
        assert te.mesh_shape(te.surviving_mesh(mesh, [])) == (1, 1)
        with pytest.raises(RuntimeError, match="all data rows failed"):
            tr.run(mesh, 4, lambda s, m: None, failures=[te.FailureEvent(3, [0])])
    assert tr.log == ["ckpt@2"]
