"""``repro_torch.launch.dryrun``'s records feed the scheduler as the
reference's do: ``run_cell`` on the llama3 smoke config in a fake (2, 2)
world writes every key the reference's ``run_cell`` writes, both packages'
``load_dryrun_profiles`` read the records into equal ``JobProfile``s, and
both packages' ``make_zoo(dryrun_dir=...)`` give equal zoos.  An unported
family's cell is recorded as failed, with its error."""
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


@pytest.fixture(autouse=True)
def _no_process_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    cfg = get_smoke_config("llama3-8b")
    out = {}
    for shape in SHAPES:
        rec = run_cell("llama3-8b", shape, verbose=False, cfg_override=cfg, test_mesh=(2, 2))
        rec["mesh"] = "pod"          # the loaders read pod records only
        (d / f"llama3-8b_{shape}_pod_baseline.json").write_text(json.dumps(rec))
        out[shape] = rec
    return d, out


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


def test_unported_family_records_its_error(tmp_path):
    rec = run_cell("qwen2-moe-a2.7b", "decode_32k", verbose=False,
                   cfg_override=get_smoke_config("qwen2-moe-a2.7b"), test_mesh=(2, 2))
    assert rec["ok"] is False and rec["error"].startswith("NotImplementedError")
    with pytest.raises(SystemExit) as e:
        main(["--arch", "jamba-v0.1-52b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 1
    (f,) = tmp_path.iterdir()
    assert json.loads(f.read_text())["ok"] is False
