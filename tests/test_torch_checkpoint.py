"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the reference's own checkpoint tests
(``tests/test_substrate.py``) run on the port, and the on-disk format is
shared both ways: a tree the reference writes (bf16, f32 and int32
leaves) restores in the port with the same bits, and a tree the port
writes has ``arrays.npz`` members byte for byte the reference's and an
equal manifest.  The reference's own restore gives a bf16 leaf back as a
raw ``V2`` array (ROADMAP.md §3 fault 8), pinned here."""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.checkpoint.checkpoint import committed_steps as j_committed
from repro_torch import checkpoint as tck


def _tree_np():
    """One tree of each dtype, as the reference's ``jax.device_get`` gives it."""
    rng = np.random.default_rng(0)
    return jax.device_get({
        "params": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                   "norm": jnp.asarray(rng.standard_normal(5), jnp.float32)},
        "opt": {"count": jnp.asarray(7, jnp.int32),
                "m": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.float32)}},
    })


def _tree_torch(tree):
    """The same tree as the port holds it (bf16 leaves as torch.bfloat16)."""
    return {k: _tree_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(
                {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int32": torch.int32}[str(v.dtype)])
            for k, v in tree.items()}


def _members(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


# -- the reference's checkpoint tests, on the port ------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(6).reshape(2, 3), "b": {"c": np.float32(1.5)}}
    tck.save(str(tmp_path), 3, tree, extra={"data_step": 7})
    got, extra, step = tck.restore(str(tmp_path), device=None)
    assert step == 3 and extra["data_step"] == 7
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_allclose(got["b"]["c"], 1.5)
    as_tensors, _, _ = tck.restore(str(tmp_path), device="cpu")
    assert torch.equal(as_tensors["a"], torch.arange(6).reshape(2, 3))
    assert as_tensors["b"]["c"].shape == () and as_tensors["b"]["c"].dtype == torch.float32


def test_checkpoint_ignores_uncommitted(tmp_path):
    tck.save(str(tmp_path), 1, {"x": np.ones(2)})
    os.makedirs(tmp_path / "step_9")          # a torn checkpoint: no .done marker
    assert tck.latest_step(str(tmp_path)) == 1


def test_checkpoint_prunes_old(tmp_path):
    for s in (1, 2, 3, 4, 5):
        tck.save(str(tmp_path), s, {"x": torch.full((2,), s)}, keep_last=2)
    assert tck.committed_steps(str(tmp_path)) == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_4.done", "step_5", "step_5.done"]


def test_restore_without_commit_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "none"))


# -- the format, both ways --------------------------------------------------------

def test_reference_checkpoint_restores_in_the_port_with_the_same_bits(tmp_path):
    tree = _tree_np()
    jck.save(str(tmp_path), 5, tree, extra={"env_steps": 11})
    got, extra, step = tck.restore(str(tmp_path), device="cpu")
    assert step == 5 and extra == {"env_steps": 11}
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16 and w.shape == (3, 5)
    assert np.array_equal(w.view(torch.int16).numpy(), tree["params"]["w"].view(np.int16))
    assert got["opt"]["count"].dtype == torch.int32 and got["opt"]["count"].shape == ()
    assert got["opt"]["count"].item() == 7
    for t, ref in ((got["params"]["norm"], tree["params"]["norm"]),
                   (got["opt"]["m"]["w"], tree["opt"]["m"]["w"])):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), ref)


def test_port_checkpoint_is_the_reference_format(tmp_path):
    tree = _tree_np()
    jck.save(str(tmp_path / "ref"), 5, tree, extra={"env_steps": 11})
    tck.save(str(tmp_path / "port"), 5, _tree_torch(tree), extra={"env_steps": 11})
    ref, port = tmp_path / "ref" / "step_5", tmp_path / "port" / "step_5"
    assert _members(port) == _members(ref)
    with open(ref / "manifest.json") as f, open(port / "manifest.json") as g:
        assert json.load(g) == json.load(f)
    assert (tmp_path / "port" / "step_5.done").read_text() == "5"
    # and the reference reads it back as it reads its own
    got, extra, step = jck.restore(str(tmp_path / "port"))
    assert step == 5 and extra == {"env_steps": 11}
    assert got["params"]["w"].dtype == np.dtype("V2")
    assert got["params"]["w"].tobytes() == tree["params"]["w"].tobytes()
    assert got["opt"]["count"].dtype == np.int32 and got["opt"]["count"].shape == ()


def test_port_restore_of_its_own_bf16_keeps_the_bits(tmp_path):
    tree = _tree_torch(_tree_np())
    tck.save(str(tmp_path), 2, tree)
    got, _, _ = tck.restore(str(tmp_path), device="cpu")
    for a, b in ((got["params"]["w"], tree["params"]["w"]),
                 (got["params"]["norm"], tree["params"]["norm"]),
                 (got["opt"]["count"], tree["opt"]["count"])):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_reference_restore_gives_bf16_as_v2(tmp_path):
    """ROADMAP.md §3 fault 8: the reference writes a bf16 leaf under the
    header ``'<V2'`` with ``"dtype": "bfloat16"`` in its manifest, and its
    restore returns the raw ``V2`` array, which ``jax.device_put`` (its
    launcher's resume, ``repro/launch/train.py:56-57``) refuses."""
    tree = _tree_np()
    jck.save(str(tmp_path), 1, tree)
    with zipfile.ZipFile(tmp_path / "step_1" / "arrays.npz") as z:
        header = z.read("params|w.npy")[:80]
    assert b"'descr': '<V2'" in header
    with open(tmp_path / "step_1" / "manifest.json") as f:
        assert json.load(f)["leaves"]["params|w"]["dtype"] == "bfloat16"
    got, _, _ = jck.restore(str(tmp_path))
    assert got["params"]["w"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        jax.device_put(got["params"]["w"])
    assert j_committed(str(tmp_path)) == [1]
