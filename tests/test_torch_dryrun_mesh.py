"""The dry-run over a mesh (``launch.dryrun --mesh``, ``op_cost`` per
rank) against the JAX package's compiled steps.

Two subprocesses run side by side.  The port's holds torch's fake process
group (``launch.mesh.init_fake``), so that no test worker keeps a process
group; the reference's runs on 256 forced host devices with
``AxisType.Auto`` meshes (``jax.make_mesh``'s Explicit axes break the
reference's sharder on jax 0.9) and reads ``memory_analysis()`` of the
compiled steps.  They check:

- each family's per-rank argument bytes at (2, 2), train and decode cells
  of the smoke configs (hymba with its window below the cells' rows, as
  the reference's ``cache_axes`` needs), against the reference's
  ``argument_size_in_bytes`` on 4 devices;
- qwen2-0.5b and qwen2-72b ``decode_32k`` on the (16, 16) mesh, per-rank
  argument bytes within 1% of the reference's on 256 devices;
- attention's head gather (``layers._qkv_layout``): one all-gather over
  "model" of q at 2 KV heads over 4 model ranks, none at 4;
- rank 0's dot FLOPs at (2, 2) times 4 against the one-card count of
  qwen2-0.5b's smoke train cell (nothing replicated in its products);
- the CLI's ``ok`` record of ``--arch qwen2_0p5b --shape decode_32k --mesh
  single``.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))

COMMON = r'''
import dataclasses, json, sys
FAMILIES = {"qwen": ("qwen2_0p5b", {}), "granite": ("granite_moe_3b_a800m", {}),
            "rwkv": ("rwkv6_3b", {}), "hymba": ("hymba_1p5b",
                                                {"sliding_window": 16}),
            "whisper": ("whisper_base", {}), "paligemma": ("paligemma_3b", {})}
KINDS = ("train", "decode")
CELL = (32, 4)           # seq, batch
FULL = ("qwen2_0p5b", "qwen2_72b")
'''

JAX_SIDE = COMMON + r'''
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_config, get_smoke_config
from repro.models.config import ShapeCell, shape_cell
from repro.optim import adamw
from repro.train import step as TS

out = {}


def mesh(shape, names=("data", "model")):
    n = int(np.prod(shape))
    devs = np.asarray(jax.devices()[:n]).reshape(shape)
    return Mesh(devs, names, axis_types=(AxisType.Auto,) * len(names))


def argument_bytes(cfg, cell, m):
    opt = adamw(1e-4, weight_decay=0.1) if cell.kind == "train" else None
    with m:
        jitted, plan = TS.jit_step_for_cell(cfg, cell, m, opt)
        with plan.sharder():
            traced = jitted.trace(plan.abstract_state, plan.abstract_inputs)
            lowered = traced.lower()
        ma = lowered.compile().memory_analysis()
    return int(ma.argument_size_in_bytes)


m = mesh((2, 2))
for key, (arch, over) in FAMILIES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    for kind in KINDS:
        out[f"{key}/{kind}"] = argument_bytes(cfg, ShapeCell("c", *CELL, kind),
                                              m)
big = mesh((16, 16))
for arch in FULL:
    out[f"{arch}/decode_32k"] = argument_bytes(get_config(arch),
                                               shape_cell("decode_32k"), big)
json.dump(out, open(sys.argv[1], "w"))
print("JAX_SIDE_OK", flush=True)
'''

PORT_SIDE = COMMON + r'''
import logging, os, subprocess
import torch
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun as D, mesh as MESH, op_cost as OC
from repro_torch.models import layers as L, model as M
from repro_torch.models.config import ShapeCell, shape_cell
from repro_torch.optim import adamw
from repro_torch.train import step as TS

out = {}
# the CLI, in a process of its own, beside this one
cli = subprocess.Popen(
    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
     "qwen2_0p5b", "--shape", "decode_32k", "--mesh", "single", "--out",
     sys.argv[2]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    text=True)

MESH.init_fake(4)
m = MESH.make_mesh((2, 2), ("data", "model"))
for key, (arch, over) in FAMILIES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    for kind in KINDS:
        got = D.analyse(cfg, ShapeCell("c", *CELL, kind), m)
        out[f"{key}/{kind}"] = got["argument_bytes"]
        if key == "qwen" and kind == "train":
            out["dots/mesh"] = sum(got["dot_flops"].values())
# whisper's encoder parameters a rank holds: its decode step reads the
# cache's enc_out and never the encoder
_, plan = TS.jit_step_for_cell(get_smoke_config("whisper_base"),
                               ShapeCell("c", *CELL, "decode"), m)
p = plan.place(plan.abstract_state, plan.param_shardings)
out["whisper/encoder"] = OC.storage_bytes(OC.tensors(
    {k: p[k] for k in ("enc_layers", "enc_norm")}))
cfg = get_smoke_config("qwen2_0p5b")
out["dots/one"] = sum(D.analyse(cfg, ShapeCell("c", *CELL, "train"))[
    "dot_flops"].values())

# attention's head gather at (1, 4): q's 4 heads over 4 model ranks
m14 = MESH.make_mesh((1, 4), ("data", "model"))
for kv in (2, 4):
    c = dataclasses.replace(cfg, n_kv_heads=kv)
    _, plan = TS.jit_step_for_cell(c, ShapeCell("c", *CELL, "train"), m14,
                                   adamw(1e-4))
    p = plan.place(plan.abstract_state["params"],
                   plan.param_shardings)["layers"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    x = plan.place(torch.empty((4, 32, c.d_model), device="meta"),
                   ("data",))
    with plan.sharder():
        _, cost = OC.count(lambda p, x: L.attention_block(p, x, c), p, x,
                           mesh=m14)
    out[f"gather/{kv}"] = [(g.op, g.axis, g.bytes) for g in cost.collectives]

# the loss over logits split on the vocabulary at (2, 2), forward and
# backward: all-reduces only, none larger than the rank's (B, S) rows
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.train.losses import softmax_cross_entropy
meta = torch.device("meta")
lg = distribute_tensor(torch.empty((4, 8, 128), device=meta), m,
                       (Shard(0), Shard(2)), src_data_rank=None)
lab = distribute_tensor(torch.empty((4, 8), dtype=torch.int32, device=meta),
                        m, (Shard(0), Replicate()), src_data_rank=None)
lg.requires_grad_()


def loss_step(lg, lab):
    with implicit_replication():
        loss, _ = softmax_cross_entropy(lg, lab)
        loss.backward()


_, cost = OC.count(loss_step, lg, lab, mesh=m)
out["loss"] = [(g.op, g.axis, g.bytes) for g in cost.collectives]

for arch in FULL:
    MESH.init_fake(256)
    big = MESH.make_production_mesh()
    out[f"{arch}/decode_32k"] = D.analyse(get_config(arch),
                                          shape_cell("decode_32k"),
                                          big)["argument_bytes"]
out["cli"] = cli.communicate(timeout=600)[0][-3000:]
out["cli_rc"] = cli.returncode
json.dump(out, open(sys.argv[1], "w"))
print("PORT_SIDE_OK", flush=True)
'''

TIMEOUT = 600


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_mesh")
    jscript, pscript = d / "jax_side.py", d / "port_side.py"
    jscript.write_text(JAX_SIDE)
    pscript.write_text(PORT_SIDE)
    ref, port, recs = d / "ref.json", d / "port.json", d / "records"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(jscript), str(ref)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=dict(
            env, XLA_FLAGS="--xla_force_host_platform_device_count=256")),
        subprocess.Popen([sys.executable, str(pscript), str(port),
                          str(recs)], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return (json.loads(ref.read_text()), json.loads(port.read_text()), recs,
            time.perf_counter() - t0)


KEYS = ["qwen", "granite", "rwkv", "hymba", "whisper", "paligemma"]


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("key", KEYS)
def test_argument_bytes_per_rank_match_reference(runs, key, kind):
    """Equal, but for whisper's decode step: it reads the encoder memory
    from the cache (``enc_out``) and never the encoder's parameters,
    which ``jax.jit`` drops from its arguments (``keep_unused=False``)
    and the port's step holds: the difference is their bytes a rank."""
    ref, port, _, _ = runs
    unused = port["whisper/encoder"] if (key, kind) == ("whisper",
                                                        "decode") else 0
    assert unused == 0 or unused > 0.2 * port[f"{key}/{kind}"]
    assert port[f"{key}/{kind}"] - unused == ref[f"{key}/{kind}"]


@pytest.mark.parametrize("arch", ["qwen2_0p5b", "qwen2_72b"])
def test_production_mesh_argument_bytes_match_reference(runs, arch):
    """decode_32k on (16, 16): 0.196 and 5.676 GiB a rank."""
    ref, port, _, _ = runs
    got, want = port[f"{arch}/decode_32k"], ref[f"{arch}/decode_32k"]
    assert abs(got - want) <= 0.01 * want, (got / 2 ** 30, want / 2 ** 30)


def test_head_gather_counted_only_past_the_groups(runs):
    """At (1, 4) attention's 4 q heads split over 4 model ranks: with 2
    KV groups they are gathered (one all-gather of q, (4, 32, 4, 16)
    float32, over "model"); with 4 each rank keeps its head."""
    _, port, _, _ = runs
    q_bytes = 4 * 32 * 4 * 16 * 4
    gathers = [g for g in port["gather/2"] if g[0] == "all-gather"]
    assert gathers == [["all-gather", "model", q_bytes]]
    assert not [g for g in port["gather/4"] if g[0] == "all-gather"]


def test_rank_dot_flops_are_a_quarter_of_one_card(runs):
    _, port, _, _ = runs
    assert abs(4 * port["dots/mesh"] - port["dots/one"]) <= \
        0.01 * port["dots/one"]


def test_cli_writes_a_mesh_record(runs):
    _, port, recs, _ = runs
    assert port["cli_rc"] == 0, port["cli"]
    rec = json.loads((recs / "qwen2_0p5b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "single"
    assert rec["chips"] == 256
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes", "fits_hbm"} and mem["fits_hbm"]
    assert rec["cost"]["flops_global"] == 256 * rec["cost"]["flops_per_rank"]
    assert rec["collectives_by_axis"]["total"]["count"] == \
        rec["collectives"]["total"]["count"] > 0
    assert {k.split(" over ")[1] for k in rec["collectives_by_axis"]
            if k != "total"} <= {"data", "model"}
    assert "[dryrun] qwen2_0p5b__decode_32k__single: ok" in port["cli"]


def test_loss_all_reduces_are_batch_sized(runs):
    """The loss over a vocabulary split on "model": all-reduces only
    (forward; none in the backward), over "model" each at most the
    rank's (2, 8) float32 rows, never the (2, 8, 64) logits."""
    _, port, _, _ = runs
    colls = port["loss"]
    assert colls and {c[0] for c in colls} == {"all-reduce"}
    assert all(c[2] <= 2 * 8 * 4 for c in colls if c[1] == "model")
    assert any(c[1] == "model" for c in colls)
