"""Fault-tolerant checkpointing: atomic, manifest-based, auto-resume.

Port of ``repro/checkpoint/checkpoint.py``, with its layout kept exactly:

    <dir>/step_<N>/manifest.json     tree structure + metadata
    <dir>/step_<N>/arrays.npz        flattened leaves keyed by ``|``-joined paths
    <dir>/step_<N>.done              commit marker, written last

``latest_step`` only considers committed checkpoints (with a ``.done``
marker), so a failure mid-save is never resumed from a torn checkpoint.
Trees are nested dicts of torch tensors, numpy arrays or scalars; the
leaves are written as numpy arrays, in the reference's tree order (sorted
keys), so the ``.npy`` members of ``arrays.npz`` are byte for byte those
the reference writes for the same values.

bfloat16: the reference writes a bf16 leaf as numpy does an
``ml_dtypes.bfloat16`` array, its 16-bit patterns under the header
``'descr': '<V2'``, and its manifest says ``"dtype": "bfloat16"``.  A bf16
tensor is written the same way here.  numpy reads such a member back as a
raw ``V2`` array (the reference's ``restore`` returns that, and its
launcher cannot resume from it: ROADMAP.md §3); :func:`restore` here reads
each leaf's dtype from the manifest and gives a bf16 leaf back as a
``torch.bfloat16`` tensor with the same bits.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile

import numpy as np
import torch

_SEP = "|"
_BF16_DESCR = "<V2"       # numpy's header for an ml_dtypes.bfloat16 array


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as ``(array to write, manifest dtype)``; a bf16 tensor as its
    16-bit patterns (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _flatten(tree: dict, prefix: str = "") -> dict[str, tuple[np.ndarray, str]]:
    flat = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        v = tree[k]
        flat.update(_flatten(v, key + _SEP) if isinstance(v, dict) else {key: _to_numpy(v)})
    return flat


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _write_npz(path: str, flat: dict[str, tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s archive (stored members ``<key>.npy``, zip64), with a
    bf16 leaf's member under the reference's ``'<V2'`` header."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
                    f.write(arr.tobytes(order="C"))
                else:
                    np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)


def save(ckpt_dir: str, step: int, tree: dict, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; prunes old committed steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": int(step),
        "extra": extra or {},
        "leaves": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in flat.items()},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    try:
        _write_npz(os.path.join(tmp, "arrays.npz"), flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # commit marker written last -> crash-safe
        with open(final + ".done", "w") as f:
            f.write(str(step))
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    _prune(ckpt_dir, keep_last)
    return os.path.join(ckpt_dir, f"step_{step}")


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = committed_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
        marker = os.path.join(ckpt_dir, f"step_{s}.done")
        if os.path.exists(marker):
            os.remove(marker)


def committed_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".done"):
            steps.append(int(name[len("step_"):-len(".done")]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    arr = np.asarray(arr, order="C")        # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def restore(ckpt_dir: str, step: int | None = None, device="cuda") -> tuple[dict, dict, int]:
    """Returns ``(tree, extra, step)``; raises FileNotFoundError if no step
    is committed.  The leaves are tensors on ``device``, each of its
    manifest dtype (a bf16 leaf as ``torch.bfloat16``); with
    ``device=None``, the numpy arrays as read, as the reference returns
    them (a bf16 leaf as a raw ``V2`` array)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    if device is not None:
        leaves = manifest["leaves"]
        flat = {k: _to_torch(v, leaves[k]["dtype"], device) for k, v in flat.items()}
    return _unflatten(flat), manifest["extra"], int(manifest["step"])
