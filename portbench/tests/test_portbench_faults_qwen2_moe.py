"""``qwen2-moe.prefill-decode`` at smoke size on the CPU, through the whole harness (the
look for a chip skipped): sound, it is correct; with the timed path broken
underneath (``smoke.FAULTS``), or with the control (the reference in
float8) in the program's place, it is not."""
import pytest

from portbench.tests import smoke

CELL = "qwen2-moe.prefill-decode"


def test_sound_run_is_correct():
    out = smoke.run(CELL)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]


@pytest.mark.parametrize("name", smoke.FAULTS)
def test_fault_is_caught(name):
    with smoke.fault(name):
        out = smoke.run(CELL)
    assert not out["correct"] and out["failed"] > 0, out["checks"]


def test_control_fails():
    out = smoke.run(CELL, control=True, wider=True)
    assert out["correct"] and out["control"]["failed"] > 0, out["control"]["checks"]


@pytest.mark.parametrize("macro_steps", [2, 3])
def test_a_stale_prefill_output_is_caught_whichever_input_set_the_last_step_took(macro_steps):
    """At 7 prefill steps a macro-step the last step takes input set 0 or 1
    by the number of macro-steps; under ``prefill_repeats_first`` its own
    output is then right or wrong, and the fingerprint of the step before
    it is wrong or right: either way the check fails."""
    import torch

    from portbench import check, harness

    spec = smoke.spec(CELL)
    with smoke.fault("prefill_repeats_first"):
        cell = harness.Cell(spec, 7, "cpu")
        for _ in range(macro_steps):
            cell.macro_step()
        sets = {t.name: t.sample[0] for t in cell.tenants if t.kind == "prefill"}
        cell.release()
        with torch.no_grad():
            prog, _ = check.check(cell.tenants, cell.weights, spec["config"])
    assert sets["prefill"] == (7 * macro_steps - 1) % 2
    assert check.verdict(prog, spec["limits"])[2] > 0
