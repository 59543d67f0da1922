"""``seamless.encode-decode`` at smoke size on the CPU, through the whole harness (the
look for a chip skipped): sound, it is correct; with the timed path broken
underneath (``smoke.FAULTS``), or with the control (the reference in
float8) in the program's place, it is not."""
import pytest

from portbench.tests import smoke

CELL = "seamless.encode-decode"


def test_sound_run_is_correct():
    out = smoke.run(CELL)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]


@pytest.mark.parametrize("name", smoke.FAULTS)
def test_fault_is_caught(name):
    with smoke.fault(name):
        out = smoke.run(CELL)
    assert not out["correct"] and out["failed"] > 0, out["checks"]


def test_control_fails():
    out = smoke.run(CELL, control=True)
    assert out["correct"] and out["control"]["failed"] > 0, out["control"]["checks"]
