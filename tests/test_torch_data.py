"""The port's synthetic data pipeline against the reference's
(``repro/data/pipeline.py``): the same batches, bit for bit, in both modes,
the same shard bounds and the same row slices."""
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JPipe
from repro_torch.data import DataPipeline as TPipe, batch_to_device


@pytest.mark.parametrize("mode", ["uniform", "markov"])
@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 64, 4, 0), (128_256, 33, 7, 12345)])
def test_batches_bit_equal(mode, vocab, seq, batch, seed):
    j, t = JPipe(vocab, seq, batch, seed, mode), TPipe(vocab, seq, batch, seed, mode)
    for step in (0, 1, 17):
        jb, tb = j.batch(step), t.batch(step)
        assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])
    full = t.batch(3)
    assert full["tokens"].shape == (batch, seq)
    assert full["tokens"].min() >= 0 and full["tokens"].max() < vocab
    np.testing.assert_array_equal(full["tokens"][:, 1:], full["labels"][:, :-1])


@pytest.mark.parametrize("mode", ["uniform", "markov"])
def test_shards_and_row_slices(mode):
    j, t = JPipe(512, 16, 10, 3, mode), TPipe(512, 16, 10, 3, mode)
    for n_shards in (1, 3, 4, 10):
        bounds = [t.shard_bounds(s, n_shards) for s in range(n_shards)]
        assert bounds == [j.shard_bounds(s, n_shards) for s in range(n_shards)]
        assert bounds[0][0] == 0 and bounds[-1][1] == 10
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        full = t.batch(5)
        for lo, hi in bounds:
            part, ref = t.batch(5, lo, hi), j.batch(5, lo, hi)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(part[k], ref[k])
                np.testing.assert_array_equal(part[k], full[k][lo:hi])


def test_batch_to_device_and_bad_mode():
    b = TPipe(100, 8, 2, 0).batch(0)
    for dtype in (torch.int64, torch.int32):
        out = batch_to_device(b, "cpu", dtype)
        assert all(v.dtype == dtype and v.device.type == "cpu" for v in out.values())
        np.testing.assert_array_equal(out["tokens"].numpy(), b["tokens"])
    with pytest.raises(ValueError):
        batch_to_device(b, "cpu", torch.float32)
    with pytest.raises(ValueError):
        TPipe(100, 8, 2, 0, mode="zipf")
