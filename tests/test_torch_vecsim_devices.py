"""``VectorizedClusterSimulator.sweep(devices=...)``, the reference's
``pmap`` over devices (``repro/online/vecsim.py: sweep``), on the port.

- A list: one device, or a count that does not divide the batch, runs the
  unsharded sweep in both packages (the reference's own test,
  ``tests/test_vecsim.py: test_sweep_sharded_matches_unsharded``, on the
  port; its traces give the reference's lanes within rtol 1e-6, the bound
  of ``tests/test_torch_vecsim.py``); a device listed twice with a count
  that divides raises ``ValueError`` in both; several distinct devices
  raise in the port, which shards over a ``DeviceMesh`` instead (ROADMAP.md
  §3); ``param_sets`` ignores ``devices``, as the reference does.
- A 1-D ``DeviceMesh`` of 4 gloo processes: every rank's gathered lanes
  (time sharing and the golden agent's RL engine, with and without
  ``with_metrics``) equal the unsharded sweep's, counts exactly and floats
  within rtol 1e-6 (the reference test's bound); 7 traces do not divide
  and run unsharded on every rank.  One spawn runs every mesh case
  (``tests/torch_vecsim_devices_parity.py``); a ``FileStore`` under
  ``tmp_path`` needs no port.

Two JAX compiles: the reference's sweep of 8 traces, and its ``pmap``
over a device listed twice (which raises)."""
import json

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_vecsim_devices_parity as parity
from repro import online as jo
from strategies import ZOO as JZOO

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The reference's engine and test traces, its unsharded sweep."""
    eng = jo.VectorizedClusterSimulator(jo.TimeSharingPolicy(), window=8, backfill=True,
                                        capacity=64)
    traces = [jo.TRACE_FAMILIES["diurnal"](JZOO, n=24, load=1.2, seed=s) for s in range(8)]
    return eng, traces, eng.sweep(traces)


@pytest.fixture(scope="module")
def port():
    eng = parity.engine("ts", False)
    traces = parity.traces(8)
    return eng, traces, eng.sweep(traces)


def test_one_device_list_is_the_unsharded_sweep_in_both_packages(ref, port):
    """The reference's test on both packages, then the port's lanes against
    the reference's (this pins ROADMAP.md §3 fault 12: the port raised)."""
    jeng, jtraces, jbase = ref
    teng, ttraces, tbase = port
    for a, b in zip(jbase, jeng.sweep(jtraces, devices=jax.devices())):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    for name, a, b in zip(tbase._fields, tbase, teng.sweep(ttraces, devices=[CPU])):
        assert torch.equal(a, b), name
    for name, a, b in zip(tbase._fields, jbase, tbase):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, err_msg=name)
    assert int(tbase.dispatches.min()) > 0 and tbase.makespan.shape == (8,)


def test_list_of_devices_follows_the_reference(ref, port):
    """Listed twice, a count that divides the batch raises (``pmap``
    refuses it); three entries do not divide 8 and run unsharded; several
    distinct devices raise in the port and name the ``DeviceMesh`` form."""
    jeng, jtraces, jbase = ref
    teng, ttraces, tbase = port
    with pytest.raises(ValueError):
        jeng.sweep(jtraces, devices=jax.devices() * 2)
    for a, b in zip(jbase, jeng.sweep(jtraces, devices=jax.devices() * 3)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    for devices in ([CPU, CPU], ["cpu", CPU], jax.devices() * 2):
        with pytest.raises(ValueError, match="more than once"):
            teng.sweep(ttraces, devices=devices)
    for name, a, b in zip(tbase._fields, tbase, teng.sweep(ttraces, devices=[CPU] * 3)):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="DeviceMesh"):
        teng.sweep(ttraces, devices=[CPU, torch.device("meta")])
    with pytest.raises(ValueError, match="empty"):      # checked first, as the reference
        teng.sweep([], devices=[CPU, CPU])


def test_param_sets_ignore_devices():
    """The reference returns a population's lanes before it reads
    ``devices``: a list that would raise is not looked at."""
    eng = parity.engine("rl", False)
    traces = [t[:10] for t in parity.traces(2)]
    pop = [eng.policy.agent.params,
           {k: v + 0.1 for k, v in eng.policy.agent.params.items()}]
    want = eng.sweep(traces, param_sets=pop)
    got = eng.sweep(traces, devices=[CPU, CPU], param_sets=pop)
    assert want.makespan.shape == (2, 2)
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    out = d / "out.json"
    mp.spawn(parity.run, args=(4, str(d / "store"), str(out)), nprocs=4)
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", list(parity.CASES))
def test_mesh_sweep_gives_every_rank_the_unsharded_lanes(mesh_results, case):
    rec = mesh_results[case]
    assert rec["lanes"] == parity.CASES[case][1]
    assert len(rec["ranks"]) == 4
    for r, cmp in enumerate(rec["ranks"]):
        assert cmp["same_fields"] and cmp["counts_equal"], (r, cmp)
        assert cmp["floats_close"], (r, cmp)
    if parity.CASES[case][2]:     # last_sweep_metrics holds the gathered metrics
        assert rec["stored"] == [True] * 4


def test_mesh_form_refusals(mesh_results):
    ref = mesh_results["refusals"]
    assert ref["2d_mesh"].startswith("ValueError: sweep shards over a 1-D DeviceMesh"), ref
    assert ref["engine_elsewhere"].startswith("ValueError: this rank's device"), ref


def test_a_one_rank_mesh_is_the_unsharded_sweep_bit_for_bit():
    """A world of one (as ``chip_smoke.py`` phase 13 runs it on the card):
    the one shard is the whole batch, and the gather gives it back."""
    from repro_torch.launch.mesh import launcher_mesh

    eng = parity.engine("ts", True)
    traces = parity.traces(4)
    want = eng.sweep(traces, with_metrics=True)
    with launcher_mesh(1, 1, "cpu"):
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("lanes",))
        got = eng.sweep(traces, devices=mesh, with_metrics=True)
    for a, b in zip(want, got):
        for name, x, y in zip(a._fields, a, b):
            assert torch.equal(x, y), name
