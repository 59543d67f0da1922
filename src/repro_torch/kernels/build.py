"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C entry
point, compiled for ``sm_90a`` into ``build/repro_torch/`` at the root of
the checkout the first time a kernel is used.  The library's file name
carries a hash of its sources, so an edited kernel is rebuilt and a stale
library is never loaded.  :func:`build_all` starts one ``nvcc`` per source,
all at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

# C entry point of each library and its arguments (pointers, ints, the
# softmax scale or eps, the CUDA stream); see the extern "C" function of each
# source
_ENTRY = {
    "decode_attention": ("decode_attention_launch",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_void_p]),
    "flash_attention": ("flash_attention_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_void_p]),
    "rmsnorm": ("rmsnorm_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}

_loaded: dict = {}   # kernel name -> its C launcher, once loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=tuple(_ENTRY)) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes in parallel.  Returns each new build's ptxas report
    (registers, shared memory, spills); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def ptxas_report(log: str) -> list[str]:
    """ptxas's lines in a build's log: each kernel's name (as
    ``name<template arguments>``), then its registers and spills, and any
    warning (a wgmma serialised, a setmaxnreg ignored)."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # a mangled name in the package's namespace: its length, then itself
            m = re.search(r"repro_torch(\d+)", line)
            if m:
                name = line[m.end():m.end() + int(m[1])]
                targs = line[m.end() + int(m[1]):].split("EEv")[0]
                dtype = {"If": ["float"], "I13__nv_bfloat16": ["bfloat16"]}
                args = next((v for k, v in dtype.items() if targs.startswith(k)), []) + \
                    re.findall(r"Li(\d+)E", targs)
                out.append(f"{name}<{', '.join(args)}>:" if args else f"{name}:")
            else:
                out.append(line.strip())
        elif any(w in line for w in ("registers", "spill", "arning", "Performance Loss")):
            out.append(line.strip())
    return out


def load(name: str):
    """The C launcher of kernel ``name`` (its library built first if
    needed), with its argument types declared."""
    fn = _loaded.get(name)
    if fn is None:
        build_all((name,))
        symbol, argtypes = _ENTRY[name]
        fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero status from a C launcher (a cudaError_t, -1 for
    a shape the kernel does not take, -2 for a TMA tensor map that
    cuTensorMapEncodeTiled refused)."""
    if err == -1:
        raise ValueError(f"{what}: shape or dtype not supported by the kernel")
    if err == -2:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA tensor map")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_sm90(t) -> None:
    """The kernels are compiled for sm_90a and run only on Hopper."""
    import torch

    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the CUDA kernels need an sm_90 (Hopper) card, got sm_{cap[0]}{cap[1]}")
