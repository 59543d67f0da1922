#!/usr/bin/env python3
"""Time design variants of the bf16 flash kernel: ``tools/kernel_variants.py
--kernel flash_attention``, under its earlier name.

    python3 tools/flash_variants.py [--parent DIR]
"""
import runpy
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.argv[1:1] = ["--kernel", "flash_attention"]
    runpy.run_path(str(Path(__file__).with_name("kernel_variants.py")), run_name="__main__")
