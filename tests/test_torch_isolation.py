"""The port stands alone: importing every ``repro_torch`` module pulls in
neither jax nor the JAX package, and its entry points do not fall back
to the CPU when no card is present.

The import check runs in a fresh interpreter, because this test process
already imported jax (tests/conftest.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = (out.stdout.split("\n") + [""])[:2]
    assert int(n) >= 20, out.stdout
    assert bad == "", f"repro_torch imported {bad}"


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.config import BranchSpec
    from repro_torch.train import filter_train as TT
    spec = BranchSpec(layer=1, grid=4, n_classes=2, head_dim=8)
    trunk = TT.default_trunk(d_model=16, n_layers=1, grid=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_filter_model(0, trunk, spec, 8)
    p = TT.init_filter_model(0, trunk, spec, 8, device="cpu")
    embeds = np.zeros((2, 16, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.filter_forward(p, trunk, spec, embeds)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.filter_forward(p, trunk, spec, embeds, use_kernel=True,
                          device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2)})
    # on the CPU when asked, and then only there
    out = TT.filter_forward(p, trunk, spec, embeds, use_kernel=True,
                            device="cpu")
    assert out.counts.device.type == "cpu"
