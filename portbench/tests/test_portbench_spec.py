"""Every cell of ``BENCHMARK.json`` finds its configuration, traffic,
limits and metric readers by name, and the file keeps the contract's
shape."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_shape_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    spec = harness.load_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["tenants"] and spec["per_layer"] and len(spec["end_to_end"]) >= 2
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
    # each limit names a number one of the cell's tenants reads, with a statistic
    kinds = {t["name"]: t["step"] for t in spec["traffic"]["tenants"]}
    readable = {"prefill": {"kv_rel_err", "kv_pos_median_err", "token_gap", "logits_rel_err"},
                "decode": {"token_gap", "logits_rel_err"}}
    assert spec["limits"]
    for name, lim in spec["limits"].items():
        tenant, number = name.split(".")
        assert number in readable[kinds[tenant]] and lim["stat"] in ("max", "row_median_max")
        assert lim["limit"] > 0
    assert set(kinds) == {n.split(".")[0] for n in spec["limits"]}


@pytest.mark.parametrize("cell", CELLS)
def test_config_builds_the_program_config(cell):
    spec = harness.load_spec(cell)
    cfg = harness.model_config(spec["config"])
    assert cfg.d_model == spec["config"]["d_model"] and cfg.dtype == spec["config"]["dtype"]
    assert {"source", "reduced", "assumed"} <= set(spec["config"])


def test_run_without_a_card_prints_no_result():
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                           CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == "", (proc.stdout, proc.stderr)
    assert "needs 1 CUDA card" in proc.stderr
