"""The port stands alone: importing every ``repro_torch`` module pulls in
neither jax, nor the JAX package, nor msgpack (the reference's
checkpoint format; the card's machine has none), and its entry points
do not fall back to the CPU when no card is present.

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
             if k.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"))
print(len(names))
print(",".join(bad))
print(",".join(names))
"""


def test_port_imports_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, names = (out.stdout.split("\n") + ["", ""])[:3]
    assert int(n) >= 20, out.stdout
    assert bad == "", f"repro_torch imported {bad}"
    # the walk reaches every subpackage, the fleet engine's too
    for mod in ("repro_torch.core.temporal", "repro_torch.distributed",
                "repro_torch.distributed.multistream",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.ctx",
                "repro_torch.distributed.serve_attention",
                "repro_torch.distributed.pipeline",
                "repro_torch.launch.mesh", "repro_torch.launch.specs",
                "repro_torch.train.step",
                "repro_torch.checkpoint.manager", "repro_torch.launch.train",
                "repro_torch.launch.serve"):
        assert mod in names.split(","), names


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


def test_mesh_entry_points_default_to_cuda(tmp_path):
    """The mesh modules start NCCL on the card unless the CPU is asked
    for; on the CPU a one-rank gloo group gives the (1, 1) host mesh,
    and the production meshes refuse a group of another size."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as LM
    with pytest.raises(RuntimeError, match="CUDA"):
        LM.init_distributed()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        LM.make_production_mesh()
    LM.init_distributed("cpu", init_file=str(tmp_path / "store"), rank=0,
                        world_size=1)
    try:
        assert dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="CUDA"):
            LM.make_host_mesh()
        m = LM.make_host_mesh("cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.shape) == (1, 1) and m.device_type == "cpu"
        assert SH.stream_mesh(device="cpu").mesh_dim_names == ("stream",)
        with pytest.raises(ValueError, match="devices"):
            SH.stream_mesh(2, device="cpu")
        with pytest.raises(RuntimeError, match="256 ranks"):
            LM.make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="512 ranks"):
            LM.make_production_mesh(multi_pod=True, device="cpu")
        with pytest.raises(ValueError, match="needs 4 ranks"):
            LM.make_mesh((2, 2), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_fleet_mesh_entry_points(tmp_path):
    """The fleet's mesh path: ``stream_mesh`` and the engine run on CUDA
    unless the CPU is asked for; ``mesh=`` without an initialised process
    group raises; nothing falls back to one card."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    import torch.distributed as dist
    from repro_torch.core import query as Q
    from repro_torch.core.aggregates import CVAccumulator, distributed_reduce
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.multistream import (ShardedPlanGroupEngine,
                                                     route_streams)
    from repro_torch.launch import mesh as LM
    queries = (Q.ClassCount(0, Q.Op.GE, 1),)
    ctxs = route_streams(["a", "b"], 1)
    LM.init_distributed("cpu", init_file=str(tmp_path / "store"), rank=0,
                        world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            SH.stream_mesh()
        m = SH.stream_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedPlanGroupEngine(queries, ctxs, None, mesh=m)
        eng = ShardedPlanGroupEngine(queries, ctxs, None, mesh=m,
                                     device="cpu")
        assert eng.shard_wrap is not None and eng.wrap_sig[0] == "mesh"
        with pytest.raises(ValueError, match="one-axis"):
            SH.ShardMap(m, ())
        acc = CVAccumulator.init(1, device="cpu").update(
            torch.arange(4.0), torch.ones(4, 1))
        red = distributed_reduce(acc, mesh=m)
        assert float(red.n) == 4.0
    finally:
        dist.destroy_process_group()
    # the mesh outlives its group: asking for it now raises
    with pytest.raises(RuntimeError, match="process group"):
        ShardedPlanGroupEngine(queries, ctxs, None, mesh=m, device="cpu")
