"""The kernel tools still fit the CUDA sources they edit: every line that
``tools/kernel_variants.py`` replaces to make a variant occurs exactly once
in its source, and ``tools/flash_phases.py`` finds the consumer loop of the
flash kernel at heads of 64 and its producer's first load.  (What the tools
measure is a question for the card.)"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


kernel_variants = _load("kernel_variants")
flash_phases = _load("flash_phases")

VARIANTS = [(kernel, name) for kernel, spec in sorted(kernel_variants.KERNELS.items())
            for name in spec["variants"]]


@pytest.mark.parametrize("kernel,variant", VARIANTS)
def test_variant_sites_occur_once(kernel, variant):
    spec = kernel_variants.KERNELS[kernel]
    text = (ROOT / spec["source"]).read_text()
    for old, new in spec["variants"][variant]:
        assert old != new
        assert text.count(old) == 1, f"{kernel} / {variant}: {old!r} occurs {text.count(old)} times"


def test_flash_phases_counts_every_statement_of_the_loop():
    text = flash_phases.SOURCE.read_text()
    counted, names = flash_phases.instrument(text)
    assert any("softmax_tile_at" in n for n in names) and any("store_p" in n for n in names)
    assert any("qk_issue" in n for n in names) and any("pv_issue" in n for n in names)
    assert counted.count("PHASE_MARK(") == len(names) + 1   # the marks and the macro
    assert f"g_cycles[{len(names) + 1}]" in counted
    unloaded = flash_phases.without_loads(text)
    assert unloaded.count("continue;") == text.count("continue;") + 1
