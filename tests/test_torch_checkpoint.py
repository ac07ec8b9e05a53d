"""The port's checkpoint manager, token pipeline and launchers, on the CPU.

- Twins of the eight tests of ``tests/test_checkpoint.py`` (the
  resharding restore becomes a restore onto a named device and dtype; a
  mismatched target raises ``ValueError`` where the reference asserts).
- The twin of ``tests/test_train_serve.py::test_checkpoint_train_resume``
  at the reference's rtol 1e-6.
- The port's ``arr_<i>.npy`` against the reference's, file by file,
  after the same 3 steps from the same state (same order, shapes and
  dtypes; values at the parameters' 1e-4 / 1e-3 allclose, the step
  equal); ``meta.json`` in place of ``meta.msgpack``.
- bfloat16 leaves round-trip bit for bit.
- ``TokenStream`` equal to the reference's for 3 batches;
  ``DeviceLoader`` keeps order, skips a corrupt batch and raises a
  placement error in the consumer; ``ShardedLoader`` does too on two
  gloo ranks, placing each batch as DTensors by the plan's specs.
- ``launch.train.main`` on the CPU (``--smoke --device cpu``) with
  checkpoints, then a resume; ``launch.serve.main`` on the CPU.
"""
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as RCK
from repro.data import pipeline as RDP
from repro.optim import adamw as r_adamw
from repro.train import step as RTS
from repro_torch.checkpoint import manager as CKPT
from repro_torch.data import pipeline as TDP
from repro_torch.interop import state_from_numpy
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.train import step as TTS

from test_torch_train_step import as_jax, as_torch, make_batch
from test_torch_zoo import port_config
from torch_parity import assert_close, to_numpy_tree


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.arange(4.0)},
            "step": torch.tensor(seed, dtype=torch.int32)}


def _template(st):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), st)


def _assert_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------------
# twins of tests/test_checkpoint.py
# --------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    st = _state(3)
    CKPT.save(str(tmp_path), st, step=3)
    restored, step = CKPT.restore(str(tmp_path), _template(st),
                                  device="cpu")
    assert step == 3
    _assert_equal(st, restored)
    assert sorted(restored) == ["params", "step"]


def test_latest_and_retention(tmp_path):
    for s in (1, 2, 3, 4, 5):
        CKPT.save(str(tmp_path), _state(s), step=s, keep_n=2)
    assert CKPT.latest_step(str(tmp_path)) == 5
    assert CKPT.all_steps(str(tmp_path)) == [4, 5]


def test_atomicity_no_partial_dirs(tmp_path):
    CKPT.save(str(tmp_path), _state(), step=7)
    assert [d for d in os.listdir(tmp_path) if d.startswith(".tmp")] == []
    # a directory without its meta.json is not a checkpoint
    os.makedirs(tmp_path / "step_000000000009")
    assert CKPT.all_steps(str(tmp_path)) == [7]


def test_async_save(tmp_path):
    t = CKPT.save_async(str(tmp_path), _state(9), step=9)
    t.join(timeout=60)
    assert not t.is_alive()
    assert CKPT.latest_step(str(tmp_path)) == 9


def test_async_save_snapshots_before_returning(tmp_path):
    st = _state(2)
    want = st["params"]["w"].clone()
    t = CKPT.save_async(str(tmp_path), st, step=2)
    st["params"]["w"].add_(1.0)         # the training step moves on
    t.join(timeout=60)
    restored, _ = CKPT.restore(str(tmp_path), _template(st), device="cpu")
    assert torch.equal(restored["params"]["w"], want)


def test_restore_mismatch_raises(tmp_path):
    CKPT.save(str(tmp_path), _state(), step=1)
    bad = {"params": {"w": torch.zeros((8, 4))}}      # missing leaf
    with pytest.raises(ValueError, match="leaf count"):
        CKPT.restore(str(tmp_path), bad, device="cpu")
    wrong = _template(_state())
    wrong["params"]["w"] = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(str(tmp_path), wrong, device="cpu")


def test_manager_policy_and_preemption(tmp_path):
    mgr = CKPT.CheckpointManager(str(tmp_path), every=5, keep_n=2,
                                 async_save=False)
    st = _state()
    for step in range(12):
        mgr.step(st, step)
    mgr.wait()
    assert CKPT.latest_step(str(tmp_path)) == 10
    # simulate preemption: the next step boundary saves synchronously
    mgr.preempt.requested = True
    mgr.step(st, 12)
    assert CKPT.latest_step(str(tmp_path)) == 12


def test_restore_or_init(tmp_path):
    mgr = CKPT.CheckpointManager(str(tmp_path), every=1, async_save=False)
    devices = []

    def init(device):
        devices.append(str(device))
        return tree_map(lambda x: x.to(device), _state(5))

    st, step = mgr.restore_or_init(init, device="cpu")
    assert step == -1 and devices == ["cpu"]           # fresh init
    CKPT.save(str(tmp_path), st, step=4)
    st2, step2 = mgr.restore_or_init(init, device="cpu")
    assert step2 == 4 and devices == ["cpu", "meta"]   # structure only
    _assert_equal(st, st2)


def test_restore_onto_named_device_and_dtype(tmp_path):
    """The resharding restore's twin: the checkpoint restores onto the
    device and dtypes the target names."""
    st = _state(1)
    CKPT.save(str(tmp_path), st, step=1)
    tmpl = _template(st)
    tmpl["params"]["w"] = torch.empty((8, 4), dtype=torch.float64,
                                      device="meta")
    restored, _ = CKPT.restore(str(tmp_path), tmpl, device=torch.device(
        "cpu"))
    w = restored["params"]["w"]
    assert w.device.type == "cpu" and w.dtype == torch.float64
    assert torch.equal(w, st["params"]["w"].double())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CKPT.restore(str(tmp_path), tmpl)          # default: the card


# --------------------------------------------------------------------------
# against the reference's files; bf16
# --------------------------------------------------------------------------

def _three_steps(tiny_dense):
    rc, tc = tiny_dense, port_config(tiny_dense)
    ropt, topt = r_adamw(1e-3), t_adamw(1e-3)
    rstate = RTS.init_state(jax.random.PRNGKey(0), rc, ropt)
    tstate = state_from_numpy(to_numpy_tree(rstate), "cpu")
    batch = make_batch(rc, 4, 16, seed=0)
    r_step = jax.jit(RTS.build_train_step(rc, ropt))
    t_step = TTS.build_train_step(tc, topt)
    for _ in range(3):
        rstate, _ = r_step(rstate, as_jax(batch))
        tstate, _ = t_step(tstate, as_torch(batch))
    return rstate, tstate, t_step, batch


def test_checkpoint_train_resume_and_files_match_reference(tmp_path,
                                                           tiny_dense):
    """The twin of test_checkpoint_train_resume (rtol 1e-6), and the
    port's files beside the reference's after the same 3 steps."""
    rstate, state, step_fn, batch = _three_steps(tiny_dense)
    CKPT.save(str(tmp_path / "port"), state, step=3)
    state_a = state
    for _ in range(2):
        state_a, ma = step_fn(state_a, as_torch(batch))
    opt = t_adamw(1e-3)
    tmpl = TTS.init_state(torch.Generator().manual_seed(0),
                          port_config(tiny_dense), opt, device="meta")
    state_b, step = CKPT.restore(str(tmp_path / "port"), tmpl, device="cpu")
    assert step == 3 and int(state_b["step"]) == 3
    for _ in range(2):
        state_b, mb = step_fn(state_b, as_torch(batch))
    assert_close(ma["loss"], mb["loss"].numpy(), rtol=1e-6, atol=0)
    for a, b in zip(tree_leaves(state_a["params"]),
                    tree_leaves(state_b["params"])):
        assert_close(a, b.numpy(), rtol=0, atol=1e-6)

    RCK.save(str(tmp_path / "ref"), rstate, step=3)
    d_port = tmp_path / "port" / "step_000000000003"
    d_ref = tmp_path / "ref" / "step_000000000003"
    assert (d_port / "meta.json").exists()
    assert not (d_port / "meta.msgpack").exists()
    names = sorted(os.listdir(d_ref))
    assert sorted(os.listdir(d_port)) == [
        "meta.json" if n == "meta.msgpack" else n for n in names]
    meta = json.loads((d_port / "meta.json").read_text())
    n = len(meta["leaves"])
    assert n == len(jax.tree.leaves(rstate))
    for i in range(n):
        got = np.load(d_port / f"arr_{i}.npy")
        want = np.load(d_ref / f"arr_{i}.npy")
        assert got.shape == want.shape and got.dtype == want.dtype, i
        if i == n - 1:                                # the step counter
            assert got == want == 3
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(7)
    st = {"w": torch.randn((5, 3), generator=g).to(torch.bfloat16),
          "inf": torch.tensor([float("inf"), -0.0, 1e-40]).to(
              torch.bfloat16),
          "m": torch.randn((3,), generator=g)}
    CKPT.save(str(tmp_path), st, step=0)
    meta = json.loads((tmp_path / "step_000000000000" / "meta.json")
                      .read_text())
    assert [x["dtype"] for x in meta["leaves"]] == \
        ["bfloat16", "float32", "bfloat16"]
    restored, _ = CKPT.restore(str(tmp_path), _template(st), device="cpu")
    for k in st:
        assert restored[k].dtype == st[k].dtype
        assert torch.equal(restored[k].view(torch.int16)
                           if st[k].dtype == torch.bfloat16 else restored[k],
                           st[k].view(torch.int16)
                           if st[k].dtype == torch.bfloat16 else st[k])


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------

def test_token_stream_equals_reference():
    a = iter(RDP.TokenStream(300, 3, 17, seed=5))
    b = iter(TDP.TokenStream(300, 3, 17, seed=5))
    for _ in range(3):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


class Flaky:
    """Yields batch i = {"x": [i]}; the read of batch 2 fails."""

    def __init__(self, n):
        self.i, self.n = 0, n

    def __iter__(self):
        return self

    def __next__(self):
        i = self.i
        self.i += 1
        if i >= self.n:
            raise StopIteration
        if i == 2:
            raise OSError("corrupt shard")
        return {"x": np.array([i], np.int64)}


def test_loader_order_skip_and_placement_error():
    with TDP.DeviceLoader(Flaky(6), device="cpu") as loader:
        got = [int(b["x"][0]) for b in loader]
        assert got == [0, 1, 3, 4, 5]
        assert loader.skipped == 1
        with pytest.raises(StopIteration):
            next(loader)

    def bad():
        yield {"x": np.zeros(2)}
        yield {"x": np.array([object()])}          # cannot be placed

    loader = TDP.DeviceLoader(bad(), device="cpu")
    assert next(loader)["x"].shape == (2,)
    with pytest.raises(TypeError):
        next(loader)
    loader.close()

    # an endless stream stops when closed
    loader = TDP.DeviceLoader(iter(TDP.TokenStream(10, 2, 4)), device="cpu")
    first = next(loader)
    assert first["tokens"].dtype == torch.int32
    loader.close()
    assert not loader._thread.is_alive()


SHARDED_LOADER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as TDP
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw
from repro_torch.train import step as TS

store, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_distributed("cpu", init_file=store, rank=rank, world_size=2)
mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
cfg = get_smoke_config("qwen2_0p5b")
plan = TS.make_plan(cfg, ShapeCell("t", 16, 4, "train"), mesh, adamw(1e-3))


class Flaky:
    # the token stream's first 4 batches; the read of batch 2 fails

    def __init__(self):
        self.it, self.i = iter(TDP.TokenStream(cfg.vocab_size, 4, 16,
                                               seed=3)), 0

    def __iter__(self):
        return self

    def __next__(self):
        b, self.i = next(self.it), self.i + 1
        if self.i > 4:
            raise StopIteration
        if self.i == 3:
            raise OSError("corrupt shard")
        return b


want = [b for i, b in zip(range(4), TDP.TokenStream(cfg.vocab_size, 4, 16,
                                                   seed=3)) if i != 2]
out = {"specs": {k: list(map(str, v))
                 for k, v in plan.input_shardings.items()}}
with TDP.ShardedLoader(Flaky(), plan.input_shardings, plan.mesh) as loader:
    got = list(loader)
    out["skipped"] = loader.skipped
out["n"] = len(got)
out["ok"] = all(
    type(b[k]).__name__ == "DTensor"
    and b[k].placements == SH.placements(plan.input_shardings[k], mesh)
    and tuple(b[k].to_local().shape) == (2, 16)
    and np.array_equal(b[k].full_tensor().numpy(), w[k])
    for b, w in zip(got, want) for k in ("tokens", "labels"))


def stray():
    yield {"tokens": np.zeros((4, 16), np.int32)}
    yield {"tokens": np.zeros((4, 16), np.int32),
           "stray": np.zeros((4, 16), np.int32)}    # no spec for it


loader = TDP.ShardedLoader(stray(), plan.input_shardings, plan.mesh)
next(loader)
try:
    next(loader)
    out["raised"] = None
except KeyError as e:
    out["raised"] = str(e)
loader.close()
with open(path, "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


def test_sharded_loader_on_two_ranks(tmp_path):
    """``ShardedLoader`` on two gloo ranks over a (2, 1) mesh: every batch
    arrives as DTensors with the plan's input placements (each rank
    holding its 2 of the 4 rows, the whole equal to the stream's batch),
    a corrupt batch is skipped and counted, and a batch key without a
    spec raises in the consumer."""
    import subprocess
    import sys
    script = tmp_path / "loader.py"
    script.write_text(SHARDED_LOADER)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "src")), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), str(r),
         str(tmp_path / f"r{r}.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    for r in range(2):
        with open(tmp_path / f"r{r}.json") as f:
            out = json.load(f)
        assert out["specs"] == {"tokens": ["data"], "labels": ["data"]}
        assert out["n"] == 3 and out["skipped"] == 1 and out["ok"], out
        assert out["raised"] == "'stray'", out


# --------------------------------------------------------------------------
# the launchers
# --------------------------------------------------------------------------

@pytest.fixture
def sigterm_kept():
    """The launcher installs a SIGTERM handler (preemption); put the
    process's own back afterwards."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys,
                                                sigterm_kept):
    from repro_torch.launch import train as LT
    ck = str(tmp_path / "ck")
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
            "--ckpt-dir", ck, "--ckpt-every", "2", "--log-every", "1"]
    run = LT.main(argv + ["--steps", "4"])
    assert run.start == 0 and len(run.losses) == 4
    assert all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms))
    assert abs(run.losses[0] - np.log(256)) < 1.0
    assert CKPT.all_steps(ck) == [0, 2]
    out = capsys.readouterr().out
    assert "step     3 loss" in out and out.strip().endswith("done.")
    resumed = LT.main(argv + ["--steps", "6"])
    assert resumed.start == 3 and len(resumed.losses) == 3
    assert CKPT.all_steps(ck) == [0, 2, 4]
    # without a checkpoint directory, and an encoder-decoder / a VLM
    for arch in ("whisper_base", "paligemma_3b"):
        r = LT.main(["--smoke", "--device", "cpu", "--arch", arch,
                     "--steps", "1", "--batch", "2", "--seq", "32"])
        assert np.isfinite(r.losses[0])


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as LS
    res = LS.main(["--device", "cpu", "--frames", "128", "--batch", "32",
                   "--train-steps", "8", "--query", "q4"])
    out = capsys.readouterr().out
    for want in ("[serve] processed", "[serve] selectivity",
                 "[serve] filter"):
        assert want in out
    assert res["frames_processed"] + res["dropped"] == 128
    # answers are the oracle's on the survivors, and false elsewhere
    np.testing.assert_array_equal(res["answers"],
                                  res["truth"] & res["survived"])
    assert 0.0 <= res["recall"] <= 1.0
