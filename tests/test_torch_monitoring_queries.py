"""The twin of examples/monitoring_queries.py (the paper's §IV-B
experiment) on the CPU: its own copy of q1-q7 against the reference's
``QUERIES`` (benchmarks/table3_query_speedup.py), and the twin run end
to end with ``--device cpu``.

The queries are held exactly: the same ``eval_objects`` answer on every
collected frame of each query's scene, for the strict and the tolerant
query, and the same candidate mask from ``eval_filters`` of the
tolerant query on the same filter outputs in both packages.  The run is
held to the experiment's invariant: answers on the cascade's survivors
are the exact semantics and every other frame answers False.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.table3_query_speedup import ORACLE_MS as R_ORACLE_MS
from benchmarks.table3_query_speedup import QUERIES as R_QUERIES
from repro.core import query as RQ
from repro.core.filters import FilterOutputs as RFilterOutputs
from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.data.synthetic import PRESETS, VideoStream, collect


def _example():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_monitoring_queries.py")
    spec = importlib.util.spec_from_file_location("torch_monitoring_queries",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("i", range(len(R_QUERIES)))
def test_twin_queries_answer_as_the_reference_queries(i):
    twin = _example()
    name, scene_name, strict, tolerant = twin.QUERIES[i]
    r_name, r_scene, r_strict, r_tolerant = R_QUERIES[i]
    assert (name, scene_name) == (r_name, r_scene)
    assert twin.ORACLE_MS == R_ORACLE_MS
    scene = PRESETS[scene_name]
    data = collect(VideoStream(scene, dynamics_seed=i), 256)
    for mine, ref in ((strict(), r_strict()), (tolerant(), r_tolerant())):
        got = [Q.eval_objects(mine, o, scene.n_classes, scene.grid)
               for o in data["objects"]]
        want = [RQ.eval_objects(ref, o, scene.n_classes, scene.grid)
                for o in data["objects"]]
        assert got == want
    rng = np.random.default_rng(i)
    counts = rng.normal(1.0, 1.5, (256, scene.n_classes)).astype(np.float32)
    grid = rng.normal(-1.0, 1.5, (256, scene.grid, scene.grid,
                                  scene.n_classes)).astype(np.float32)
    got = Q.eval_filters(tolerant(), FilterOutputs(
        counts=torch.as_tensor(counts), grid=torch.as_tensor(grid)))
    want = RQ.eval_filters(r_tolerant(), RFilterOutputs(
        counts=jnp.asarray(counts), grid=jnp.asarray(grid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twin_runs_on_the_cpu(capsys):
    results = _example().main(["--device", "cpu", "--steps", "3",
                               "--frames", "32"])
    out = capsys.readouterr().out
    assert [r["name"] for r in results] == [f"q{i}" for i in range(1, 8)]
    twin = _example()
    for r, (_, scene_name, strict, _) in zip(results, twin.QUERIES):
        scene = PRESETS[scene_name]
        exact = np.array([Q.eval_objects(strict(), o, scene.n_classes,
                                         scene.grid) for o in r["objects"]])
        np.testing.assert_array_equal(r["truth"], exact)
        np.testing.assert_array_equal(r["answers"], exact & r["mask"])
        assert r["mask"].shape == (32,) and 0.0 <= r["selectivity"] <= 1.0
        assert 0.0 <= r["recall"] <= 1.0 and r["speedup"] > 0
        assert r["name"] in out and r["scene"] in out


def test_twin_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example().main(["--steps", "1"])
