"""The port's mesh path on four gloo ranks against the JAX package's on
four host CPU devices.

One JAX subprocess (``--xla_force_host_platform_device_count=4``, meshes
built with ``AxisType.Auto``: ``jax.make_mesh`` gives Explicit axes on
jax 0.9, whose ``with_sharding_constraint`` refuses them) and four port
processes (a gloo group from a file store) run side by side on the same
inputs, each drawn with numpy from a per-leaf seed, and write npz files:

- the GPipe pipeline at 4 stages of a 4-layer model (against the
  reference's and against ``run_layers``);
- ``decode_shard``: prefill + two decode steps of ``tiny_dense`` on a
  sequence-sharded cache at mesh shapes (1, 4) and (2, 2), the second
  step's row the first of another rank's slice at (1, 4);
- ``jit_step_for_cell`` at (2, 2): two train steps, a prefill and a
  decode step of ``tiny_dense`` and of qwen2-0.5b's smoke config.

The port's sharded results are also held against its own unsharded
step on the same inputs.  Tolerances: logits 1e-4, cache rows 1e-5 (the
reference's own decode-shard test), losses and gradient norms 1e-4
(``tests/test_kernels.py``'s allclose); after two AdamW steps the
moments within 1e-4 of each leaf's largest and the parameters within
1e-3 of the rate, where the gradients are not near AdamW's eps.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.abspath(os.path.join(ROOT, "src"))

LR = 1e-3                # AdamW's rate in the planned train steps

# inputs shared by both sides: numpy draws keyed by leaf path
COMMON = f"LR = {LR!r}\n" + r'''
import zlib
import numpy as np

BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=128, dtype="float32", max_seq_len=256,
            attn_impl="xla_naive", scan_layers=True)
PIPE = dict(name="p", n_layers=4, d_model=32, n_heads=4, n_kv_heads=2,
            head_dim=8, d_ff=64, vocab_size=64, dtype="float32",
            attn_impl="xla_naive", scan_layers=False)
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
TRAIN = (4, 32)          # batch, seq of the plan's cells (cache rows 32)
BATCH_SEEDS = ((21, 22), (24, 25))   # tokens, labels of train steps 1, 2
PROMPT = 24              # prefill tokens of the plan's prefill cell
DS = (2, 32, 8)          # decode_shard: batch, cache rows, prompt


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def unflat(d, prefix):
    tree = {}
    for k, v in d.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def draw(shapes):
    """{path: float32 array}: norm weights 1 + 0.1 n, the rest 0.1 n."""
    out = {}
    for path, shape in shapes.items():
        r = np.random.default_rng(zlib.crc32(path.encode()))
        a = 0.1 * r.standard_normal(shape)
        if path.endswith("/w") or path.endswith("ln_w"):
            a = a + 1.0
        out[path] = a.astype(np.float32)
    return out


def ints(seed, shape, hi):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)
'''

JAX_SIDE = COMMON + r'''
import os, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.configs import get_smoke_config
from repro.distributed import ctx as CTX
from repro.distributed.pipeline import make_pipelined_forward
from repro.models import model as M, serve as SV
from repro.models.config import ModelConfig, ShapeCell
from repro.optim import adamw
from repro.train import step as TS

out = {}


def mesh(shape, names):
    devs = np.asarray(jax.devices()[:4]).reshape(shape)
    return Mesh(devs, names, axis_types=(AxisType.Auto,) * len(names))


def params_of(cfg):
    shapes = {k: tuple(v.shape) for k, v in flat(jax.eval_shape(
        lambda: M.init_params(jax.random.PRNGKey(0), cfg))).items()}
    return unflat({k: jnp.asarray(v) for k, v in draw(shapes).items()}, "")


# the pipeline
pcfg = ModelConfig(**PIPE)
pp = params_of(pcfg)
x = np.random.default_rng(7).standard_normal((4, 2, 8, 32)).astype(np.float32)
fn = make_pipelined_forward(pcfg, mesh((4,), ("pod",)), pipe_axis="pod",
                            n_micro=4)
out["pipe"] = np.asarray(fn(pp["layers"], jnp.asarray(x)))

# decode_shard: prefill + two decode steps on a seq-sharded cache
dense = ModelConfig(name="dense", **BASE)
dp = params_of(dense)
B, S, n = DS
toks = ints(11, (B, n + 2), dense.vocab_size)
for name, shape in MESHES.items():
    m = mesh(shape, ("data", "model"))
    with m, CTX.decode_shard(m, seq_axis="model", batch_axes=("data",)):
        cache = SV.init_cache(dense, B, S)
        _, cache, _ = SV.prefill(dp, dense, jnp.asarray(toks[:, :n]),
                                 cache=cache)
        for i in range(2):
            lg, cache = SV.decode_step(dp, dense, jnp.asarray(
                toks[:, n + i:n + i + 1]), cache=cache)
            out[f"ds/{name}/logits{i}"] = np.asarray(lg)
        out[f"ds/{name}/k"] = np.asarray(cache["layers"]["k"])

# jit_step_for_cell at (2, 2)
m = mesh((2, 2), ("data", "model"))
for key, cfg in (("dense", dense), ("qwen", get_smoke_config("qwen2_0p5b"))):
    p = params_of(cfg)
    Bt, St = TRAIN
    opt = adamw(LR, weight_decay=0.1)
    for k, v in flat(p).items():
        out[f"plan/{key}/old/{k}"] = np.asarray(v)
    state = {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}
    toks = ints(23, (Bt, PROMPT + 1), cfg.vocab_size)
    with m:
        step, plan = TS.jit_step_for_cell(cfg, ShapeCell("t", St, Bt, "train"),
                                          m, opt)
        for i, (ts, ls) in enumerate(BATCH_SEEDS):
            batch = {"tokens": jnp.asarray(ints(ts, (Bt, St), cfg.vocab_size)),
                     "labels": jnp.asarray(ints(ls, (Bt, St), cfg.vocab_size))}
            with plan.sharder():
                state, met = step(state, batch)
            out[f"plan/{key}/loss{i}"] = np.asarray(met["loss"])
            out[f"plan/{key}/grad_norm{i}"] = np.asarray(met["grad_norm"])
            if i == 0:
                for k, v in flat(state["opt"]["m"]).items():
                    out[f"plan/{key}/m_first/{k}"] = np.asarray(v)
        for k, v in flat(state["params"]).items():
            out[f"plan/{key}/new/{k}"] = np.asarray(v)
        for k, v in flat(state["opt"]).items():
            out[f"plan/{key}/opt/{k}"] = np.asarray(v)
        pstep, pplan = TS.jit_step_for_cell(
            cfg, ShapeCell("p", St, Bt, "prefill"), m)
        with pplan.sharder():
            lg, cache = pstep(p, {"tokens": jnp.asarray(toks[:, :PROMPT]),
                                  "cache": SV.init_cache(cfg, Bt, St)})
        out[f"plan/{key}/prefill"] = np.asarray(lg)
        out[f"plan/{key}/prefill_k"] = np.asarray(cache["layers"]["k"])
        dstep, dplan = TS.jit_step_for_cell(
            cfg, ShapeCell("d", St, Bt, "decode"), m)
        with dplan.sharder():
            lg, cache = dstep(p, {"tokens": jnp.asarray(toks[:, PROMPT:]),
                                  "cache": cache})
        out[f"plan/{key}/decode"] = np.asarray(lg)
        out[f"plan/{key}/decode_k"] = np.asarray(cache["layers"]["k"])

np.savez(sys.argv[1], **out)
print("JAX_SIDE_OK", flush=True)
'''

PORT_SIDE = COMMON + r'''
import logging, os, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import ctx, sharding as SH
from repro_torch.distributed.pipeline import make_pipelined_forward
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import model as M, serve as SV
from repro_torch.models.config import ModelConfig, ShapeCell
from repro_torch.optim import adamw
from repro_torch.train import step as TS

store, rank, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
init_distributed("cpu", init_file=store, rank=rank, world_size=4)
t0 = time.perf_counter()
out = {}
CPU = "cpu"


def params_of(cfg):
    shapes = {k: tuple(v.shape) for k, v in flat(M.init_params(
        torch.Generator(), cfg, device="meta")).items()}
    return unflat({k: torch.from_numpy(v) for k, v in draw(shapes).items()},
                  "")


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# the pipeline, and run_layers on the same stack
pcfg = ModelConfig(**PIPE)
pp = params_of(pcfg)
x = torch.from_numpy(np.random.default_rng(7).standard_normal(
    (4, 2, 8, 32)).astype(np.float32))
fn = make_pipelined_forward(pcfg, make_mesh((4,), ("pod",), device=CPU),
                            pipe_axis="pod", n_micro=4)
out["pipe"] = fn(pp["layers"], x).numpy()
ref, _, _ = M.run_layers(pp["layers"], x.reshape(8, 8, 32), pcfg)
out["pipe_plain"] = ref.reshape(4, 2, 8, 32).numpy()

# decode_shard through the plan's placements
dense = ModelConfig(name="dense", **BASE)
dp = params_of(dense)
B, S, n = DS
toks = torch.from_numpy(ints(11, (B, n + 2), dense.vocab_size))
for name, shape in MESHES.items():
    mesh = make_mesh(shape, ("data", "model"), device=CPU)
    _, plan = TS.jit_step_for_cell(dense, ShapeCell("p", S, B, "prefill"),
                                   mesh)
    params = plan.place(dp, plan.param_shardings)
    cache = plan.place_inputs({"cache": SV.init_cache(dense, B, S,
                                                      device=CPU)})["cache"]
    with plan.sharder(), ctx.decode_shard(mesh, seq_axis="model"):
        _, cache, _ = SV.prefill(params, dense, plan.place(
            toks[:, :n], ("data",)), cache=cache)
        for i in range(2):
            lg, cache = SV.decode_step(params, dense, plan.place(
                toks[:, n + i:n + i + 1], ("data",)), cache=cache)
            out[f"ds/{name}/logits{i}"] = whole(lg).numpy()
    out[f"ds/{name}/k"] = whole(cache["layers"]["k"]).numpy()
    out[f"ds/{name}/k_local_rows"] = np.asarray(
        cache["layers"]["k"].to_local().shape[2])
# the unsharded port on the same inputs
cache = SV.init_cache(dense, B, S, device=CPU)
_, cache, _ = SV.prefill(dp, dense, toks[:, :n], cache=cache)
for i in range(2):
    lg, cache = SV.decode_step(dp, dense, toks[:, n + i:n + i + 1],
                               cache=cache)
    out[f"ds/plain/logits{i}"] = lg.numpy()
out["ds/plain/k"] = cache["layers"]["k"].numpy()

# jit_step_for_cell at (2, 2), and step_for_cell on the same inputs
mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
for key, cfg in (("dense", dense), ("qwen", get_smoke_config("qwen2_0p5b"))):
    p = params_of(cfg)
    Bt, St = TRAIN
    opt = adamw(LR, weight_decay=0.1)
    for k, v in flat(p).items():
        out[f"plan/{key}/old/{k}"] = v.numpy().copy()
    state = {"params": p, "opt": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    batches = [{"tokens": torch.from_numpy(ints(ts, (Bt, St), cfg.vocab_size)),
                "labels": torch.from_numpy(ints(ls, (Bt, St), cfg.vocab_size))}
               for ts, ls in BATCH_SEEDS]
    toks2 = torch.from_numpy(ints(23, (Bt, PROMPT + 1), cfg.vocab_size))
    cell = ShapeCell("t", St, Bt, "train")
    step, plan = TS.jit_step_for_cell(cfg, cell, mesh, opt)
    plain_step = TS.step_for_cell(cfg, cell, opt)
    new = pnew = state
    for i, batch in enumerate(batches):
        new, met = step(new, batch)
        pnew, pmet = plain_step(pnew, batch)
        out[f"plan/{key}/loss{i}"] = met["loss"].numpy()
        out[f"plan/{key}/grad_norm{i}"] = met["grad_norm"].numpy()
        out[f"plain/{key}/loss{i}"] = pmet["loss"].numpy()
        out[f"plain/{key}/grad_norm{i}"] = pmet["grad_norm"].numpy()
    out[f"plan/{key}/placements"] = np.asarray(
        str(new["params"]["layers"]["attn"]["wq"].placements))
    # the new state keeps the plan's layout: moments and parameters as
    # placed, whatever placement autograd gave the gradients
    placed = plan.place(state, plan.state_shardings)
    out[f"plan/{key}/layout_kept"] = np.asarray(all(
        a.placements == b.placements for a, b in zip(
            flat(new).values(), flat(placed).values())))
    for k, v in flat(new["params"]).items():
        out[f"plan/{key}/new/{k}"] = whole(v).numpy()
    for k, v in flat(new["opt"]).items():
        out[f"plan/{key}/opt/{k}"] = whole(v).numpy()
    for k, v in flat(pnew["params"]).items():
        out[f"plain/{key}/new/{k}"] = v.numpy()
    for k, v in flat(pnew["opt"]).items():
        out[f"plain/{key}/opt/{k}"] = v.numpy()

    pstep, _ = TS.jit_step_for_cell(cfg, ShapeCell("p", St, Bt, "prefill"),
                                    mesh)
    lg, cache = pstep(p, {"tokens": toks2[:, :PROMPT],
                          "cache": SV.init_cache(cfg, Bt, St, device=CPU)})
    out[f"plan/{key}/prefill"] = whole(lg).numpy()
    out[f"plan/{key}/prefill_k"] = whole(cache["layers"]["k"]).numpy()
    dstep, _ = TS.jit_step_for_cell(cfg, ShapeCell("d", St, Bt, "decode"),
                                    mesh)
    lg, cache = dstep(p, {"tokens": toks2[:, PROMPT:], "cache": cache})
    out[f"plan/{key}/decode"] = whole(lg).numpy()
    out[f"plan/{key}/decode_k"] = whole(cache["layers"]["k"]).numpy()
    c = SV.init_cache(cfg, Bt, St, device=CPU)
    lg, c, _ = SV.prefill(p, cfg, toks2[:, :PROMPT], cache=c)
    out[f"plain/{key}/prefill"] = lg.numpy()
    lg, c = SV.decode_step(p, cfg, toks2[:, PROMPT:], cache=c)
    out[f"plain/{key}/decode"] = lg.numpy()

# tree_shardings: the same placements as the plan's params
placed = SH.tree_shardings(M.param_axes(dense), dp, mesh)
_, plan = TS.jit_step_for_cell(dense, ShapeCell("d", 32, 4, "decode"), mesh)
ref_pl = plan.place(dp, plan.param_shardings)
out["tree_shardings_equal"] = np.asarray(all(
    a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
    for a, b in zip(flat(placed).values(), flat(ref_pl).values())))

# the splits the planned train step keeps at (2, 2): the loss on logits
# split on the vocabulary over "model" (no gather, nothing moved: one
# all-reduce each for the max, the sum, the label's logit and the mean,
# none in the backward), and attention's chunks,
# whose heads stay split (q's 4 heads over 2 ranks fall on whole KV
# groups); the heads gather only where they would not, at (1, 4)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models import layers as L
from repro_torch.train.losses import softmax_cross_entropy
lg = torch.from_numpy(np.random.default_rng(41).standard_normal(
    (4, 8, 128)).astype(np.float32))
lab = torch.from_numpy(ints(42, (4, 8), 128))
lab[0, :3] = -1
dlg = distribute_tensor(lg, mesh, (Shard(0), Shard(2)), src_data_rank=None)
dlg.requires_grad_()
with CommDebugMode() as comm, implicit_replication():
    loss, _ = softmax_cross_entropy(dlg, distribute_tensor(
        lab, mesh, (Shard(0), Replicate()), src_data_rank=None))
    loss.backward()
lg.requires_grad_()
ploss, _ = softmax_cross_entropy(lg, lab)
ploss.backward()
out["loss/split"] = np.asarray([float(whole(loss)), float(ploss)])
out["loss/grad_err"] = np.asarray(float(
    (whole(dlg.grad) - lg.grad).abs().max()))
out["loss/grad_split"] = np.asarray(dlg.grad.placements == dlg.placements)
out["loss/comms"] = np.asarray(sorted(str(k) for k in
                                      comm.get_comm_counts()))
seen, attend = [], L._attend
L._attend = lambda c, q, *a, **k: (seen.append(tuple(q.shape)),
                                   attend(c, q, *a, **k))[1]
_, plan = TS.jit_step_for_cell(dense, ShapeCell("t", 32, 4, "train"), mesh,
                               adamw(LR))
with torch.no_grad(), plan.sharder():
    M.forward(plan.place(dp, plan.param_shardings), dense,
              plan.place_inputs({"tokens": toks[:, :8].repeat(2, 1)})[
                  "tokens"])
L._attend = attend
out["attn/local_q"] = np.asarray(seen)
mesh14 = make_mesh((1, 4), ("data", "model"), device=CPU)
q = distribute_tensor(torch.zeros(4, 8, 4, 16), mesh14,
                      (Replicate(), Shard(2)), src_data_rank=None)
out["attn/layout_1x4"] = np.asarray(str(L._qkv_layout(q, 2)))

# the kernels' wrappers on DTensors (layers.local_call) under "pallas": the
# forward's flash call (320 x 320 scores; flash has no backward) and a
# decode step through the decode kernel's wrapper (no decode shard),
# against the one-card calls
from repro_torch.kernels import ops
kcfg = ModelConfig(name="dense", **dict(BASE, attn_impl="pallas"))
p = params_of(kcfg)
toks4 = torch.from_numpy(ints(31, (2, 320), kcfg.vocab_size))
_, plan = TS.jit_step_for_cell(kcfg, ShapeCell("p", 320, 2, "prefill"), mesh)
ops.reset_plain_counts()
with torch.no_grad(), plan.sharder():
    lg = M.forward(plan.place(p, plan.param_shardings), kcfg,
                   plan.place_inputs({"tokens": toks4})["tokens"]).logits
flash_calls = ops.plain_counts()["flash_attention_bhsd"]
with torch.no_grad():
    plg = M.forward(p, kcfg, toks4).logits
out["pallas/forward_err"] = np.asarray(float((whole(lg) - plg).abs().max()))
toks3 = torch.from_numpy(ints(33, (4, 25), kcfg.vocab_size))
pstep, _ = TS.jit_step_for_cell(kcfg, ShapeCell("p", 32, 4, "prefill"), mesh)
dstep, _ = TS.jit_step_for_cell(kcfg, ShapeCell("d", 32, 4, "decode"), mesh)
_, cache = pstep(p, {"tokens": toks3[:, :24],
                     "cache": SV.init_cache(kcfg, 4, 32, device=CPU)})
ops.reset_plain_counts()
lg, _ = dstep(p, {"tokens": toks3[:, 24:], "cache": cache})
decode_calls = ops.plain_counts()["decode_attention_bkgd"]
c = SV.init_cache(kcfg, 4, 32, device=CPU)
_, c, _ = SV.prefill(p, kcfg, toks3[:, :24], cache=c)
plg, _ = SV.decode_step(p, kcfg, toks3[:, 24:], cache=c)
out["pallas/decode_err"] = np.asarray(float((whole(lg) - plg).abs().max()))
out["pallas/calls"] = np.asarray([flash_calls, decode_calls])

# launch.train --mesh host on the group (the (1, 4) host mesh) against
# the one-card launcher: the same losses; rank 0 writes the checkpoints
from repro_torch.launch import train as LT
argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
        "--seq", "16", "--log-every", "100"]
ck = os.path.join(os.path.dirname(path), "ck_mesh")
mesh_run = LT.main(argv + ["--mesh", "host", "--ckpt-dir", ck,
                           "--ckpt-every", "2"])
one_run = LT.main(argv)
out["launcher/losses"] = np.asarray([mesh_run.losses, one_run.losses])
dist.barrier()
out["launcher/ckpt_steps"] = np.asarray(sorted(os.listdir(ck)) == [
    "step_000000000000", "step_000000000002"])

out["seconds"] = np.asarray(time.perf_counter() - t0)
dist.barrier()
if rank == 0:
    np.savez(path, **out)
dist.destroy_process_group()
print("PORT_SIDE_OK", rank, flush=True)
'''

TIMEOUT = 400


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, run side by side: ({reference}, {port}, seconds)."""
    d = tmp_path_factory.mktemp("mesh")
    jscript, pscript = d / "jax_side.py", d / "port_side.py"
    jscript.write_text(JAX_SIDE)
    pscript.write_text(PORT_SIDE)
    ref, port, store = d / "ref.npz", d / "port.npz", d / "store"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(jscript), str(ref)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen([sys.executable, str(pscript), str(store),
                                str(r), str(port)], env=env,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
              for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seconds = time.perf_counter() - t0
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    assert "JAX_SIDE_OK" in outs[0], outs[0][-4000:]
    return dict(np.load(ref)), dict(np.load(port)), seconds


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=what)


def test_both_sides_ran(runs):
    ref, port, seconds = runs
    assert float(port["seconds"]) > 0 and seconds < TIMEOUT


def test_pipeline_matches_reference_and_run_layers(runs):
    ref, port, _ = runs
    _close(port["pipe"], ref["pipe"], 1e-4, "pipeline vs reference")
    _close(port["pipe"], port["pipe_plain"], 1e-5, "pipeline vs run_layers")


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_decode_shard_matches_reference(runs, mesh):
    ref, port, _ = runs
    for i in range(2):
        _close(port[f"ds/{mesh}/logits{i}"], ref[f"ds/{mesh}/logits{i}"],
               1e-4, f"decode step {i} logits at {mesh}")
        _close(port[f"ds/{mesh}/logits{i}"], port[f"ds/plain/logits{i}"],
               1e-4, f"decode step {i}: sharded vs the port's plain decode")
    _close(port[f"ds/{mesh}/k"], ref[f"ds/{mesh}/k"], 1e-5, "cache k")
    _close(port[f"ds/{mesh}/k"], port["ds/plain/k"], 1e-5, "cache k, plain")
    # the cache really was split along the sequence
    rows = {"1x4": 8, "2x2": 16}[mesh]
    assert int(port[f"ds/{mesh}/k_local_rows"]) == rows


def _moments_close(got, want, what):
    """A moment leaf within 1e-4 of the leaf's largest value."""
    _close(got, want, 1e-4 * float(np.abs(want).max()), what)


def _updates_close(got, want, old, m_first, m_last, what):
    """The parameters after two AdamW steps, whose change is about the
    rate, within 1e-3 of the rate of ``want``, on the elements where
    each step's gradient (from the first moment after each step: m1 =
    0.1 g1, m2 = 0.9 m1 + 0.1 g2) is at least 1e-2 of its leaf's
    largest.  Elsewhere a gradient near AdamW's eps makes the step's
    size a rounding.  Returns (elements held, elements)."""
    g1, g2 = np.abs(m_first), np.abs(m_last - 0.9 * m_first)
    keep = (g1 >= 1e-2 * g1.max()) & (g2 >= 1e-2 * g2.max())
    assert np.abs(want - old)[keep].min() > 1e-2 * LR, what
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-3 * LR,
                               rtol=0, err_msg=what)
    return keep.sum(), keep.size


@pytest.mark.parametrize("key", ["dense", "qwen"])
def test_planned_train_step_matches_reference(runs, key):
    """Two planned AdamW steps (weight decay 0.1) against the reference's
    and the port's unsharded ones: the losses and gradient norms of both
    steps, both moments, and the new parameters within 1e-3 of the rate
    (a step that left the parameters alone, or updated them from one
    rank's partial gradient, is off by about the rate)."""
    ref, port, _ = runs
    for i in range(2):
        for m in ("loss", "grad_norm"):
            _close(port[f"plan/{key}/{m}{i}"], ref[f"plan/{key}/{m}{i}"],
                   1e-4, f"{m} of step {i}")
            _close(port[f"plan/{key}/{m}{i}"], port[f"plain/{key}/{m}{i}"],
                   1e-4, f"{m} of step {i}, plain")
    moments = [k for k in ref if k.startswith(f"plan/{key}/opt/")]
    assert len(moments) >= 20
    for k in moments:
        _moments_close(port[k], ref[k], k)
        _moments_close(port[k], port[k.replace("plan/", "plain/")], k)
    news = [k for k in ref if k.startswith(f"plan/{key}/new/")]
    assert len(news) >= 10
    kept = total = 0
    for k in news:
        leaf = k[len(f"plan/{key}/new/"):]
        old = ref[f"plan/{key}/old/{leaf}"]
        np.testing.assert_array_equal(port[f"plan/{key}/old/{leaf}"], old)
        ms = ref[f"plan/{key}/m_first/{leaf}"], ref[f"plan/{key}/opt/m/{leaf}"]
        n, size = _updates_close(port[k], ref[k], old, *ms, k)
        _updates_close(port[k], port[k.replace("plan/", "plain/")], old, *ms,
                       k + ", plain")
        kept, total = kept + n, total + size
    assert kept >= 0.7 * total, f"the update is held on {kept} of {total}"
    # the planned step kept the parameters sharded over the mesh, every
    # leaf of the new state laid out as the plan placed the old one
    assert "Shard" in str(port[f"plan/{key}/placements"])
    assert bool(port[f"plan/{key}/layout_kept"])


@pytest.mark.parametrize("key", ["dense", "qwen"])
def test_planned_prefill_and_decode_match_reference(runs, key):
    ref, port, _ = runs
    for what in ("prefill", "decode"):
        _close(port[f"plan/{key}/{what}"], ref[f"plan/{key}/{what}"], 1e-4,
               f"{what} logits")
        _close(port[f"plan/{key}/{what}"], port[f"plain/{key}/{what}"],
               1e-4, f"{what} logits, plain")
        _close(port[f"plan/{key}/{what}_k"], ref[f"plan/{key}/{what}_k"],
               1e-5, f"{what} cache k")


def test_tree_shardings_places_as_the_plan(runs):
    _, port, _ = runs
    assert bool(port["tree_shardings_equal"])


def test_loss_and_attention_keep_their_splits(runs):
    """At (2, 2) the loss over logits split on the vocabulary gathers
    nothing (all-reduces only), equals the whole loss, and its gradient
    stays split; attention in a planned forward runs on each rank's 2 of
    4 batch rows and 2 of 4 heads; at (1, 4), where 4 ranks would split
    2 KV groups, the heads gather."""
    _, port, _ = runs
    got, want = port["loss/split"]
    assert abs(got - want) <= 1e-6 and float(port["loss/grad_err"]) <= 1e-6
    assert bool(port["loss/grad_split"])
    comms = [str(c) for c in port["loss/comms"]]
    assert comms and all("all_reduce" in c for c in comms), comms
    assert [tuple(q) for q in port["attn/local_q"]] == [(2, 8, 2, 16)] * 2
    assert str(port["attn/layout_1x4"]) == "(Replicate(), Replicate())"


def test_kernel_wrappers_run_on_each_ranks_chunk(runs):
    """``pallas`` at (2, 2): the flash wrapper in a forward and the
    decode wrapper in a decode step, reached on each rank's chunk, match
    the one-card calls."""
    _, port, _ = runs
    flash_calls, decode_calls = port["pallas/calls"]
    assert flash_calls == 2 and decode_calls == 2    # one a layer
    assert float(port["pallas/forward_err"]) <= 1e-4
    assert float(port["pallas/decode_err"]) <= 1e-4


def test_launcher_trains_over_the_host_mesh(runs):
    _, port, _ = runs
    mesh_losses, one_losses = port["launcher/losses"]
    _close(mesh_losses, one_losses, 1e-4, "launcher losses")
    assert bool(port["launcher/ckpt_steps"])
