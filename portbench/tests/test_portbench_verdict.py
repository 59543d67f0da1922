"""The statistics that ``check.verdict`` holds to a limit: a number held
by its ``max`` fails at each answer over the limit; one held by its
``row_median_max`` lets each row have odd answers and fails every row
that is wrong at most of its answers, however few of the rows that is."""
import pytest

from portbench import check


def _readings(per_row: dict[int, list[float]]) -> check.Readings:
    r = check.Readings()
    for row, vals in per_row.items():
        r.add("decode.logits_rel_err", vals, [row] * len(vals))
    return r


def _verdict(per_row, stat, limit=0.5):
    return check.verdict(_readings(per_row), {"decode.logits_rel_err":
                                              {"stat": stat, "limit": limit}})


@pytest.mark.parametrize("bad_rows", [1, 4, 8])
def test_rows_wrong_at_every_step_fail(bad_rows):
    per_row = {r: [1.0 if r < bad_rows else 0.1] * 16 for r in range(8)}
    out, attempted, failed = _verdict(per_row, "row_median_max")
    assert attempted == 8 and failed == bad_rows and out["decode.logits_rel_err"]["value"] == 1.0


def test_a_row_wrong_at_most_of_its_steps_fails():
    per_row = {r: [0.1] * 16 for r in range(8)}
    per_row[5] = [1.0] * 9 + [0.1] * 7
    assert _verdict(per_row, "row_median_max")[2] == 1


def test_each_rows_odd_steps_pass():
    per_row = {r: [0.1] * 13 + [5.0] * 3 for r in range(8)}
    out, attempted, failed = _verdict(per_row, "row_median_max")
    assert failed == 0 and out["decode.logits_rel_err"]["value"] == pytest.approx(0.1)


def test_max_fails_each_answer_over_its_limit():
    per_row = {0: [0.1, 0.7], 1: [0.2, 0.9, 0.3]}
    out, attempted, failed = _verdict(per_row, "max")
    assert (attempted, failed) == (5, 2) and out["decode.logits_rel_err"]["value"] == 0.9


def test_a_number_without_readings_fails():
    out, attempted, failed = check.verdict(check.Readings(), {"decode.token_gap":
                                                             {"stat": "max", "limit": 1.0}})
    assert failed == 1 and attempted == 0
