"""Every fault that ``tools/kernel_mutants.py`` plants still has its place in
the CUDA sources: each site occurs exactly once, so a rewrite of a kernel
cannot leave a fault silently unplanted.  (Whether ``chip_smoke.py`` then
catches the fault is a question for the card.)"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("kernel_mutants",
                                               ROOT / "tools" / "kernel_mutants.py")
kernel_mutants = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_mutants)


@pytest.mark.parametrize("what", sorted(kernel_mutants.MUTANTS))
def test_mutant_sites_occur_once(what):
    path, sites = kernel_mutants.MUTANTS[what]
    text = (ROOT / path).read_text()
    assert sites, what
    for old, new in sites:
        assert old != new
        n = text.count(old)
        assert n == 1, f"{what}: site {old!r} occurs {n} times in {path}"
    planted = kernel_mutants.plant(text, sites, what, path)
    assert planted != text and len(planted.splitlines()) == len(text.splitlines())
