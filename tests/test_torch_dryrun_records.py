"""``repro_torch.launch.dryrun``'s records feed the scheduler as the
reference's do: ``run_cell`` on the llama3 smoke config in a fake (2, 2)
world writes every key the reference's ``run_cell`` writes, both packages'
``load_dryrun_profiles`` read the records into equal ``JobProfile``s, and
both packages' ``make_zoo(dryrun_dir=...)`` give equal zoos.  The same holds
for a cell of every other family (their smoke configs, a fake (2, 2)
world).  A cell that fails (a batch that the data axis does not divide) is
recorded as failed, with its error."""
import dataclasses
import json

import pytest
import torch.distributed as dist

from repro.core import profiles as jprofiles, workloads as jworkloads
from repro_torch.configs import get_smoke_config
from repro_torch.core import profiles, workloads
from repro_torch.launch.dryrun import main, run_cell

# every key repro/launch/dryrun.py: run_cell writes into a pod record
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "rules", "chips", "kind", "ok", "lower_s", "compile_s",
    "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes", "fits_hbm", "hbm_limit",
    "scan_units", "flops_per_chip", "bytes_per_chip", "bytes_per_chip_raw_cpu",
    "coll_bytes_weighted", "coll_bytes_raw", "coll_count_unit", "coll_by_op_u1", "coll_by_op_u2",
    "compute_term_s", "memory_term_s", "collective_term_s", "dominant", "step_time_lb_s",
    "model_flops_total", "model_flops_per_chip", "useful_flops_ratio", "model_bytes_min_total",
    "roofline_fraction",
}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# a cell of each other family: the zoo's base cells, and seamless's encoder pass
FAMILY_CELLS = (("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
                ("deepseek-moe-16b", "decode_32k"), ("jamba-v0.1-52b", "decode_32k"),
                ("chameleon-34b", "decode_32k"), ("xlstm-125m", "decode_32k"),
                ("seamless-m4t-large-v2", "prefill_32k"))


@pytest.fixture(autouse=True)
def _no_process_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _write_records(d, cells) -> dict:
    out = {}
    for arch, shape in cells:
        rec = run_cell(arch, shape, verbose=False, cfg_override=get_smoke_config(arch),
                       test_mesh=(2, 2))
        rec["mesh"] = "pod"          # the loaders read pod records only
        (d / f"{arch}_{shape}_pod_baseline.json").write_text(json.dumps(rec))
        out[arch, shape] = rec
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    out = _write_records(d, [("llama3-8b", s) for s in SHAPES])
    return d, {shape: out["llama3-8b", shape] for shape in SHAPES}


@pytest.fixture(scope="module")
def family_records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_families")
    return d, _write_records(d, FAMILY_CELLS)


@pytest.mark.parametrize("shape", SHAPES)
def test_record_has_every_reference_key(records, shape):
    rec = records[1][shape]
    assert rec["ok"], rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec)
    assert rec["chips"] == 4 and rec["scan_units"] == 2
    # eager torch traces every layer: the full trace equals the differenced count
    assert rec["flops_per_chip_full"] == pytest.approx(rec["flops_per_chip"], rel=1e-9)
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]


def _profile_fields(p):
    d = dataclasses.asdict(p)
    return {k: d[k] for k in ("name", "arch", "shape", "steps", "flops_total", "bytes_total",
                              "coll_bytes_chip_pod", "n_coll_step", "serial_s", "meta")}


def test_both_loaders_read_the_records_alike(records):
    d = str(records[0])
    got, want = profiles.load_dryrun_profiles(d), jprofiles.load_dryrun_profiles(d)
    assert sorted(got) == sorted(want) == [f"llama3-8b:{s}" for s in sorted(SHAPES)]
    for k in got:
        assert _profile_fields(got[k]) == _profile_fields(want[k])
        assert got[k].meta["source"] == "dryrun"


def test_both_zoos_from_the_records_are_equal(records):
    d = str(records[0])
    got, want = workloads.make_zoo(dryrun_dir=d), jworkloads.make_zoo(dryrun_dir=d)
    assert [_profile_fields(p) for p in got] == [_profile_fields(p) for p in want]
    assert [p.job_class for p in got] == [p.job_class for p in want]
    from_dryrun = {p.shape for p in got if p.meta.get("source") == "dryrun"}
    assert from_dryrun == set(SHAPES)


@pytest.mark.parametrize("cell", FAMILY_CELLS, ids=lambda c: "-".join(c) if isinstance(c, tuple)
                         else c)
def test_family_record_has_every_reference_key(family_records, cell):
    rec = family_records[1][cell]
    assert rec["ok"], rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec)
    assert rec["chips"] == 4
    assert rec["flops_per_chip_full"] == pytest.approx(rec["flops_per_chip"], rel=1e-9)


def test_both_loaders_and_zoos_agree_on_every_family(family_records):
    d = str(family_records[0])
    got, want = profiles.load_dryrun_profiles(d), jprofiles.load_dryrun_profiles(d)
    assert sorted(got) == sorted(want) == sorted(f"{a}:{s}" for a, s in FAMILY_CELLS)
    for k in got:
        assert _profile_fields(got[k]) == _profile_fields(want[k])
    got, want = workloads.make_zoo(dryrun_dir=d), jworkloads.make_zoo(dryrun_dir=d)
    assert [_profile_fields(p) for p in got] == [_profile_fields(p) for p in want]
    assert [p.job_class for p in got] == [p.job_class for p in want]
    from_dryrun = {(p.arch, p.shape) for p in got if p.meta.get("source") == "dryrun"}
    assert from_dryrun == set(FAMILY_CELLS[:-1])     # seamless's encoder pass is no zoo job


def test_unported_family_records_its_error(tmp_path, monkeypatch):
    """Every family is ported now (the cells above), so a cell fails for
    another reason here: a train batch of 3 rows does not divide over a
    data axis of 2 (or 16, the pod's).  It is recorded as failed with its
    error, and the CLI writes the record and exits 1."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_shape", lambda s: ShapeConfig(s, 16, 3, "train"))
    rec = run_cell("qwen2-moe-a2.7b", "train_4k", verbose=False,
                   cfg_override=get_smoke_config("qwen2-moe-a2.7b"), test_mesh=(2, 2))
    assert rec["ok"] is False and rec["error"].startswith("ValueError"), rec["error"]
    assert "does not divide" in rec["error"]
    with pytest.raises(SystemExit) as e:
        main(["--arch", "jamba-v0.1-52b", "--shape", "train_4k", "--out", str(tmp_path)])
    assert e.value.code == 1
    (f,) = tmp_path.iterdir()
    assert json.loads(f.read_text())["ok"] is False


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_heads_the_model_axis_does_not_divide(shape):
    """qwen2.5-14b's 40 q heads do not divide the pod's model axis of 16
    (ROADMAP.md §3 fault 10): the port's dry run raised, DTensor refusing to
    cut heads out of a feature shard; the q heads now stay whole on each
    rank.  The same on a (2, 2) world with 5 heads."""
    cfg = get_smoke_config("qwen2.5-14b").replace(n_heads=5, n_kv_heads=1)
    rec = run_cell("qwen2.5-14b", shape, verbose=False, cfg_override=cfg, test_mesh=(2, 2))
    assert rec["ok"], rec.get("traceback")
    assert rec["flops_per_chip_full"] == pytest.approx(rec["flops_per_chip"], rel=1e-9)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "seamless-m4t-large-v2", "xlstm-125m"])
def test_multipod_train_step_traces(arch):
    """On the multi-pod mesh (512 fake ranks) a train step at its published
    widths, one scan unit, 256 x 64 tokens, traces (ROADMAP.md §3 fault 11):
    a residual add whose ``Partial`` DTensor reduce-scattered along the
    tokens, a split of a sharded projection and the mLSTM's merged heads
    reached products and views that DTensor has no rule for."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_step, with_scan_units
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cfg = with_scan_units(get_config(arch), 1)
    with fake_world(512):
        rec = trace_step(cfg, ShapeConfig("t", 64, 256, "train"),
                         make_production_mesh(multi_pod=True, device_type="cpu"))
    assert rec["flops"] > 0
