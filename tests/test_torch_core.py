"""The port's framework-free core equals the reference exactly: configs,
parameter counts, roofline terms, job profiles, the partition table,
placement, the co-run model and the paper queues."""
import dataclasses

import numpy as np
import pytest

import repro.configs as jc
import repro_torch.configs as tc
from repro.core import partition as jpart
from repro.core import perfmodel as jperf
from repro.core import workloads as jwork
from repro.launch import roofline as jroof
from repro.models.model import count_params_analytic as j_count
from repro_torch.core import partition as tpart
from repro_torch.core import perfmodel as tperf
from repro_torch.core import workloads as twork
from repro_torch.launch import roofline as troof
from repro_torch.models.model import count_params_analytic as t_count

ZOO_J = jwork.make_zoo(dryrun_dir=None)
ZOO_T = twork.make_zoo(dryrun_dir=None)


@pytest.mark.parametrize("arch", jc.ARCH_IDS)
def test_configs_and_param_counts(arch):
    for j, t in ((jc.get_config(arch), tc.get_config(arch)),
                 (jc.get_smoke_config(arch), tc.get_smoke_config(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        for active in (False, True):
            assert j_count(j, active) == t_count(t, active)


@pytest.mark.parametrize("shape", jc.SHAPE_IDS)
def test_roofline_terms(shape):
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.ICI_BW) == (
        jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW)
    for arch in jc.ARCH_IDS:
        j, t = jc.get_config(arch), tc.get_config(arch)
        js, ts = jc.get_shape(shape), tc.get_shape(shape)
        assert troof.model_flops(t, ts) == jroof.model_flops(j, js)
        assert troof.model_bytes_min(t, ts) == jroof.model_bytes_min(j, js)
        assert troof.model_coll_bytes_chip(t, ts) == jroof.model_coll_bytes_chip(j, js)


_FIELDS = ("name", "arch", "shape", "steps", "flops_total", "bytes_total",
           "coll_bytes_chip_pod", "n_coll_step", "serial_s", "meta")


@pytest.mark.parametrize("i", range(len(ZOO_J)))
def test_zoo_profiles(i):
    j, t = ZOO_J[i], ZOO_T[i]
    assert [getattr(t, f) for f in _FIELDS] == [getattr(j, f) for f in _FIELDS]
    assert t.features() == j.features()
    assert (t.job_class, t.right_size(), t.solo_time(), t.scalability) == (
        j.job_class, j.right_size(), j.solo_time(), j.scalability)


def test_partition_table_and_offsets():
    jp, tp = jpart.enumerate_partitions(4), tpart.enumerate_partitions(4)
    assert [(p.label, p.arity, p.style, p.total_units) for p in tp] == [
        (p.label, p.arity, p.style, p.total_units) for p in jp]
    assert [[(s.units, s.shares) for s in p.slices] for p in tp] == [
        [(s.units, s.shares) for s in p.slices] for p in jp]
    rng = np.random.default_rng(0)
    for _ in range(200):
        free = [bool(b) for b in rng.integers(0, 2, jpart.N_UNITS)]
        for a, b in zip(jp, tp):
            assert tpart.find_offsets(b, free) == jpart.find_offsets(a, free)


@pytest.mark.parametrize("seed", range(4))
def test_corun_times(seed):
    rng = np.random.default_rng(seed)
    jp, tp = jpart.enumerate_partitions(4), tpart.enumerate_partitions(4)
    for pi in range(len(jp)):
        idx = rng.integers(0, len(ZOO_J), jp[pi].arity)
        gj, gt = [ZOO_J[i] for i in idx], [ZOO_T[i] for i in idx]
        rj, rt = jperf.corun(gj, jp[pi]), tperf.corun(gt, tp[pi])
        assert (rt.makespan, rt.finish_times, rt.solo_times) == (
            rj.makespan, rj.finish_times, rj.solo_times)
        assert tperf.corun_time(gt, tp[pi]) == jperf.corun_time(gj, jp[pi])
        assert tperf.solo_run_time(gt) == jperf.solo_run_time(gj)


@pytest.mark.parametrize("window", [4, 8, 12])
def test_paper_queues_membership(window):
    qj = jwork.paper_queues(ZOO_J, window=window)
    qt = twork.paper_queues(ZOO_T, window=window)
    assert {k: [j.name for j in q] for k, q in qt.items()} == {
        k: [j.name for j in q] for k, q in qj.items()}
