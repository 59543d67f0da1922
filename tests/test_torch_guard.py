"""The port stands alone: every ``repro_torch`` module imports with ``jax``,
``repro`` and ``triton`` blocked.  Runs in a subprocess so that no pytest
worker loses the JAX modules it already holds."""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_CHILD = r"""
import importlib, pkgutil, sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "triton"):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, _Block())
import repro_torch

names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not leaked, leaked
print(" ".join(names))
"""

# the training slice's modules and the third kernel
SLICE_2 = {"repro_torch.core.baselines", "repro_torch.core.metrics",
           "repro_torch.core.perfmodel_vec", "repro_torch.core.replay",
           "repro_torch.core.train", "repro_torch.kernels.rmsnorm",
           "repro_torch.kernels.rmsnorm.ops"}
# the LM training slice's modules
SLICE_5 = {"repro_torch.data", "repro_torch.data.pipeline", "repro_torch.optim",
           "repro_torch.optim.adamw", "repro_torch.runtime.lm_train"}
# the xLSTM family and the online heap path
SLICE_6 = {"repro_torch.models.xlstm", "repro_torch.online", "repro_torch.online.policies",
           "repro_torch.online.retrain", "repro_torch.online.router",
           "repro_torch.online.simulator", "repro_torch.online.telemetry",
           "repro_torch.online.traces"}
# the vectorized simulator
SLICE_7 = {"repro_torch.online.vecsim"}
# the moe, hybrid and vlm families and the serve path; 66 modules in all
SLICE_8 = {"repro_torch.models.mamba", "repro_torch.models.moe", "repro_torch.runtime.steps",
           "repro_torch.launch.serve"}


def test_repro_torch_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 66 and SLICE_2 | SLICE_5 | SLICE_6 | SLICE_7 | SLICE_8 <= names, \
        out.stdout
