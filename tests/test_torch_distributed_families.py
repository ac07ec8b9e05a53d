"""Every family's planned steps on four gloo ranks against the JAX
package's on four host CPU devices.

``tests/test_torch_distributed.py`` holds the dense attention family;
this file holds the rest of the zoo through ``jit_step_for_cell`` at the
(2, 2) mesh ("data", "model"): the smoke configs of granite-moe-3b-a800m
(MoE routing on each rank's token groups, the experts split over
"model"), rwkv6-3b (the WKV scan on each rank's batch rows and heads),
hymba-1.5b (the Mamba scan on each rank's slice of d_inner, and a ring
cache: its ``sliding_window`` set to 16 below the cells' 32 rows on both
sides, since the reference's ``cache_axes`` keys ``pos`` on the window
and its ``init_cache`` on the rows; a 15-token prompt and two decode
steps wrap it), whisper-base (cross-attention's memory and the
``enc_out`` cache) and paligemma-3b (the ``embeds`` prefix through the
prefix-LM mask, one KV head); and qwen2-0.5b's smoke config at (1, 4),
where 4 model ranks split its 2 KV heads' 4 query heads past the groups.

Each runs two AdamW train steps, a prefill and two decode steps, beside
the port's unsharded steps on the same inputs (the train steps with the
plan's two routing groups).  The harness is the dense file's (one JAX
subprocess, ``AxisType.Auto`` meshes, four port processes on a gloo
file store, inputs drawn with numpy per leaf; RWKV-6's decay bias about
its initial -0.6), and so are the tolerances: logits 1e-4, cache leaves
1e-5, losses and aux losses 1e-4, gradient norms 1e-4 of their size,
moments within 1e-4 of each leaf's largest, parameters within 1e-3 of
the rate.  ``apply_moe`` itself also runs on the mesh on both sides,
with drops, and the routing and both scans are seen on each rank's
chunk.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from test_torch_distributed import (COMMON, LR, SRC, _close, _moments_close,
                                    _updates_close)

FAMILIES = COMMON + r'''
# key -> (arch, config overrides, mesh shape, prompt tokens)
FAMILIES = {
    "granite": ("granite_moe_3b_a800m", {}, (2, 2), 24),
    "rwkv": ("rwkv6_3b", {}, (2, 2), 24),
    "hymba": ("hymba_1p5b", {"sliding_window": 16}, (2, 2), 15),
    "whisper": ("whisper_base", {}, (2, 2), 24),
    "paligemma": ("paligemma_3b", {}, (2, 2), 8),
    "qwen14": ("qwen2_0p5b", {}, (1, 4), 24),
}
CELL = (4, 32)           # batch, seq of every cell (cache rows 32)
# RWKV-6's decay bias is drawn about its initial -0.6, as the dense
# file's draw puts norm weights about 1: about 0 it would decay each token
# by e^-1, and the chunked WKV scan would then scale keys by up to e^32,
# which float32 holds to these tolerances on neither side
_draw = draw


def draw(shapes):
    out = _draw(shapes)
    for path, a in out.items():
        if path.endswith("/w0"):
            out[path] = (a - 0.6).astype(np.float32)
    return out
DECODES = 2


def floats(seed, shape):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def batch_of(cfg, B, S, seed, labels=True):
    """A step's inputs: the VLM's patch embeddings take S // 2 of the
    train cell's rows (``specs.batch_inputs``), a prefill's P of 16; an
    encoder-decoder's frames are (B, enc_len, d)."""
    out = {}
    if cfg.vlm_prefix:
        p = min(cfg.vlm_prefix, S // 2) if labels else cfg.vlm_prefix
        S = S - p if labels else S
        out["embeds"] = floats(seed + 100, (B, p, cfg.d_model))
    if cfg.enc_dec:
        out["frames"] = floats(seed + 200, (B, cfg.enc_len, cfg.d_model))
    out["tokens"] = ints(seed, (B, S), cfg.vocab_size)
    if labels:
        out["labels"] = ints(seed + 1, (B, S), cfg.vocab_size)
    return out


MOE_X = (4, 32)          # apply_moe's input (B, S) at the (2, 2) mesh


def moe_input(router, cfg):
    """apply_moe's input: draws pushed along expert 0's router column,
    so that more tokens pick expert 0 than its capacity holds."""
    r0 = router[:, 0] / np.linalg.norm(router[:, 0])
    return floats(41, MOE_X + (cfg.d_model,)) + 2.0 * r0.astype(np.float32)
'''

JAX_SIDE = FAMILIES + r'''
import dataclasses, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.configs import get_smoke_config
from repro.distributed import ctx as CTX
from repro.models import layers as LY, model as M, serve as SV
from repro.models.config import ShapeCell
from repro.optim import adamw
from repro.train import step as TS

out = {}


def mesh(shape):
    devs = np.asarray(jax.devices()[:4]).reshape(shape)
    return Mesh(devs, ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def params_of(cfg):
    shapes = {k: tuple(v.shape) for k, v in flat(jax.eval_shape(
        lambda: M.init_params(jax.random.PRNGKey(0), cfg))).items()}
    return unflat({k: jnp.asarray(v) for k, v in draw(shapes).items()}, "")


def put(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


Bt, St = CELL
for key, (arch, over, shape, prompt) in FAMILIES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    p = params_of(cfg)
    opt = adamw(LR, weight_decay=0.1)
    for k, v in flat(p).items():
        out[f"{key}/old/{k}"] = np.asarray(v)
    state = {"params": p, "opt": opt.init(p), "step": jnp.zeros((), jnp.int32)}
    m = mesh(shape)
    with m:
        step, plan = TS.jit_step_for_cell(cfg, ShapeCell("t", St, Bt, "train"),
                                          m, opt)
        for i, seed in enumerate((21, 24)):
            with plan.sharder():
                state, met = step(state, put(batch_of(cfg, Bt, St, seed)))
            for name in ("loss", "aux", "grad_norm"):
                out[f"{key}/{name}{i}"] = np.asarray(met[name])
            if i == 0:
                for k, v in flat(state["opt"]["m"]).items():
                    out[f"{key}/m_first/{k}"] = np.asarray(v)
        for k, v in flat(state["params"]).items():
            out[f"{key}/new/{k}"] = np.asarray(v)
        for k, v in flat(state["opt"]).items():
            out[f"{key}/opt/{k}"] = np.asarray(v)
        pstep, pplan = TS.jit_step_for_cell(
            cfg, ShapeCell("p", St, Bt, "prefill"), m)
        batch = put(batch_of(cfg, Bt, prompt, 31, labels=False))
        batch["cache"] = SV.init_cache(cfg, Bt, St)
        with pplan.sharder():
            lg, cache = pstep(p, batch)
        out[f"{key}/prefill"] = np.asarray(lg)
        for k, v in flat(cache).items():
            out[f"{key}/prefill_cache/{k}"] = np.asarray(v)
        dstep, dplan = TS.jit_step_for_cell(
            cfg, ShapeCell("d", St, Bt, "decode"), m)
        toks = ints(33, (Bt, DECODES), cfg.vocab_size)
        for i in range(DECODES):
            with dplan.sharder():
                lg, cache = dstep(p, {"tokens": jnp.asarray(toks[:, i:i + 1]),
                                      "cache": cache})
            out[f"{key}/decode{i}"] = np.asarray(lg)
        for k, v in flat(cache).items():
            out[f"{key}/decode_cache/{k}"] = np.asarray(v)

# apply_moe on the mesh: granite's first layer, two routing groups
cfg = get_smoke_config("granite_moe_3b_a800m")
mp = jax.tree.map(lambda a: a[0], params_of(cfg)["layers"]["moe"])
x = jnp.asarray(moe_input(np.asarray(mp["router"]), cfg))
m = mesh((2, 2))
with m:
    _, plan = TS.jit_step_for_cell(cfg, ShapeCell("t", St, Bt, "train"), m,
                                   adamw(LR))
    with plan.sharder():
        y, aux = jax.jit(lambda p, x: LY.apply_moe(p, x, cfg, groups=2))(mp, x)
out["moe/y"], out["moe/aux"] = np.asarray(y), np.asarray(aux)

np.savez(sys.argv[1], **out)
print("JAX_SIDE_OK", flush=True)
'''

PORT_SIDE = FAMILIES + r'''
import dataclasses, logging, sys, time
import torch
import torch.distributed as dist
torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import layers as L, model as M, serve as SV
from repro_torch.models.config import ShapeCell
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


def put(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def serve(key, cfg, p, prompt, pstep=None, dstep=None, tag="plan"):
    """Prefill + DECODES decode steps through the planned steps (or the
    plain ones); their logits and caches into ``out``."""
    batch = put(batch_of(cfg, Bt, prompt, 31, labels=False))
    batch["cache"] = SV.init_cache(cfg, Bt, St, device=CPU)
    if pstep is None:
        lg, cache, _ = SV.prefill(p, cfg, batch["tokens"],
                                  cache=batch["cache"],
                                  embeds=batch.get("embeds"),
                                  frames=batch.get("frames"))
    else:
        lg, cache = pstep(p, batch)
    out[f"{tag}/{key}/prefill"] = whole(lg).numpy()
    for k, v in flat(cache).items():
        out[f"{tag}/{key}/prefill_cache/{k}"] = whole(v).numpy().copy()
    toks = torch.from_numpy(ints(33, (Bt, DECODES), cfg.vocab_size))
    for i in range(DECODES):
        tok = toks[:, i:i + 1]
        if dstep is None:
            lg, cache = SV.decode_step(p, cfg, tok, cache=cache)
        else:
            lg, cache = dstep(p, {"tokens": tok, "cache": cache})
        out[f"{tag}/{key}/decode{i}"] = whole(lg).numpy()
    for k, v in flat(cache).items():
        out[f"{tag}/{key}/decode_cache/{k}"] = whole(v).numpy()
    if dstep is not None:
        out[f"{tag}/{key}/cache_placements"] = np.asarray(
            {k: str(v.placements) for k, v in flat(cache).items()
             if hasattr(v, "placements")}.__repr__())


Bt, St = CELL
for key, (arch, over, shape, prompt) in FAMILIES.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    mesh = make_mesh(shape, ("data", "model"), device=CPU)
    p = params_of(cfg)
    opt = adamw(LR, weight_decay=0.1)
    for k, v in flat(p).items():
        out[f"plan/{key}/old/{k}"] = v.numpy().copy()
    state = {"params": p, "opt": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32)}
    cell = ShapeCell("t", St, Bt, "train")
    step, plan = TS.jit_step_for_cell(cfg, cell, mesh, opt)
    # unsharded, with the plan's routing groups (MoE)
    plain_step = TS.build_train_step(cfg, opt, moe_groups=plan.moe_groups)
    new = pnew = state
    for i, seed in enumerate((21, 24)):
        batch = put(batch_of(cfg, Bt, St, seed))
        new, met = step(new, batch)
        pnew, pmet = plain_step(pnew, batch)
        for name in ("loss", "aux", "grad_norm"):
            out[f"plan/{key}/{name}{i}"] = met[name].numpy()
            out[f"plain/{key}/{name}{i}"] = pmet[name].numpy()
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
    del new, pnew, state, placed

    pstep, _ = TS.jit_step_for_cell(cfg, ShapeCell("p", St, Bt, "prefill"),
                                    mesh)
    dstep, dplan = TS.jit_step_for_cell(cfg, ShapeCell("d", St, Bt, "decode"),
                                        mesh)
    serve(key, cfg, p, prompt, pstep, dstep)
    serve(key, cfg, p, prompt, tag="plain")
    # the cache the steps return keeps the plan's placements
    out[f"plan/{key}/cache_specs"] = np.asarray(repr(
        dplan.input_shardings["cache"]))

# apply_moe on the (2, 2) mesh: granite's first layer, two routing groups
# (one per data rank), the experts split over "model"
from torch.distributed.tensor import distribute_tensor
cfg = get_smoke_config("granite_moe_3b_a800m")
mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
mp = {k: v[0] for k, v in params_of(cfg)["layers"]["moe"].items()}
x = torch.from_numpy(moe_input(mp["router"].numpy(), cfg))
_, plan = TS.jit_step_for_cell(cfg, ShapeCell("t", St, Bt, "train"), mesh,
                               adamw(LR))
dmp = plan.place({"moe": mp}, {"moe": {
    k: v[1:] for k, v in flat(plan.param_shardings["layers"]["moe"]).items()}}
                 )["moe"]
with torch.no_grad(), plan.sharder():
    y, aux = L.apply_moe(dmp, plan.place(x, ("data",)), cfg, groups=2)
out["moe/y"], out["moe/aux"] = whole(y).numpy(), whole(aux).numpy()
out["moe/wi_local"] = np.asarray(tuple(dmp["wi"].to_local().shape))
with torch.no_grad():
    py, paux = L.apply_moe(mp, x, cfg, groups=2)
    T = MOE_X[0] * MOE_X[1] // 2
    xt = x.reshape(2, T, cfg.d_model)
    _, _, slots, _ = L._dispatch(xt, torch.einsum("gtd,de->gte", xt,
                                                  mp["router"]),
                                 cfg, L.moe_capacity(T, cfg))
out["moe/plain_y"], out["moe/plain_aux"] = py.numpy(), paux.numpy()
out["moe/dropped"] = np.asarray(int((slots == cfg.n_experts *
                                     L.moe_capacity(T, cfg)).sum()))

# the routing, the WKV scan and the Mamba scan each run on the rank's
# chunk: the shapes they see in a planned train step (granite, two
# routing groups) and planned prefills (rwkv6, hymba)
from repro_torch.models import ssm as SS
seen = {}


def recording(mod, name):
    fn = getattr(mod, name)

    def rec(*a, **k):
        seen.setdefault(name, tuple(a[0].shape))
        return fn(*a, **k)
    setattr(mod, name, rec)


for mod, name in ((L, "_dispatch"), (SS, "rwkv_chunk_scan"),
                  (SS, "mamba_scan")):
    recording(mod, name)
for key in ("granite", "rwkv", "hymba"):
    arch, over, shape, prompt = FAMILIES[key]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    mesh = make_mesh(shape, ("data", "model"), device=CPU)
    p = params_of(cfg)
    if key == "granite":
        opt = adamw(LR)
        step, _ = TS.jit_step_for_cell(cfg, ShapeCell("t", St, Bt, "train"),
                                       mesh, opt)
        step({"params": p, "opt": opt.init(p),
              "step": torch.zeros((), dtype=torch.int32)},
             put(batch_of(cfg, Bt, St, 21)))
    else:
        pstep, _ = TS.jit_step_for_cell(
            cfg, ShapeCell("p", St, Bt, "prefill"), mesh)
        batch = put(batch_of(cfg, Bt, prompt, 31, labels=False))
        batch["cache"] = SV.init_cache(cfg, Bt, St, device=CPU)
        pstep(p, batch)
for name, shp in seen.items():
    out[f"local/{name}"] = np.asarray(shp)

out["seconds"] = np.asarray(time.perf_counter() - t0)
dist.barrier()
if rank == 0:
    np.savez(path, **out)
dist.destroy_process_group()
print("PORT_SIDE_OK", rank, flush=True)
'''

TIMEOUT = 400
KEYS = ["granite", "rwkv", "hymba", "whisper", "paligemma", "qwen14"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, run side by side: ({reference}, {port}, seconds)."""
    d = tmp_path_factory.mktemp("mesh_families")
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


def test_both_sides_ran(runs):
    _, port, seconds = runs
    assert float(port["seconds"]) > 0 and seconds < TIMEOUT


@pytest.mark.parametrize("key", KEYS)
def test_planned_train_steps_match_reference(runs, key):
    """Two planned AdamW steps against the reference's and the port's
    unsharded ones (with the plan's routing groups): loss, aux loss and
    gradient norm of both steps, both moments, the new parameters.
    Gradient norms are held at 1e-4 of their size: rwkv6's first is
    9.8033 in the reference and 9.8031 in the port, sharded or not.  The
    new state keeps the plan's layout."""
    ref, port, _ = runs
    for i in range(2):
        for m in ("loss", "aux", "grad_norm"):
            want = ref[f"{key}/{m}{i}"]
            tol = 1e-4 * max(1.0, abs(float(want))) if m == "grad_norm" \
                else 1e-4
            _close(port[f"plan/{key}/{m}{i}"], want, tol,
                   f"{key}: {m} of step {i}")
            _close(port[f"plan/{key}/{m}{i}"], port[f"plain/{key}/{m}{i}"],
                   tol, f"{key}: {m} of step {i}, plain")
    moments = [k for k in ref if k.startswith(f"{key}/opt/")]
    assert len(moments) >= 20
    for k in moments:
        _moments_close(port["plan/" + k], ref[k], k)
        _moments_close(port["plan/" + k], port["plain/" + k], k + ", plain")
    news = [k for k in ref if k.startswith(f"{key}/new/")]
    kept = total = 0
    for k in news:
        leaf = k[len(f"{key}/new/"):]
        old = ref[f"{key}/old/{leaf}"]
        np.testing.assert_array_equal(port[f"plan/{key}/old/{leaf}"], old)
        ms = ref[f"{key}/m_first/{leaf}"], ref[f"{key}/opt/m/{leaf}"]
        n, size = _updates_close(port["plan/" + k], ref[k], old, *ms, k)
        _updates_close(port["plan/" + k], port["plain/" + k], old, *ms,
                       k + ", plain")
        kept, total = kept + n, total + size
    assert kept >= 0.5 * total, f"the update is held on {kept} of {total}"
    assert bool(port[f"plan/{key}/layout_kept"])


@pytest.mark.parametrize("key", KEYS)
def test_planned_prefill_and_decode_match_reference(runs, key):
    """The prefill's and both decode steps' logits (1e-4) and every cache
    leaf after the prefill and after the last decode step (1e-5)."""
    ref, port, _ = runs
    for what in ["prefill"] + [f"decode{i}" for i in range(2)]:
        _close(port[f"plan/{key}/{what}"], ref[f"{key}/{what}"], 1e-4,
               f"{key}: {what} logits")
        _close(port[f"plan/{key}/{what}"], port[f"plain/{key}/{what}"],
               1e-4, f"{key}: {what} logits, plain")
    for when in ("prefill_cache", "decode_cache"):
        leaves = [k for k in ref if k.startswith(f"{key}/{when}/")]
        assert leaves
        for k in leaves:
            _close(port["plan/" + k], ref[k], 1e-5, k)
            _close(port["plan/" + k], port["plain/" + k], 1e-5, k + ", plain")


def test_hymba_ring_wraps(runs):
    """hymba's ring of 16 rows: after a 15-token prompt and two decode
    steps, slot 0 holds position 16 and slot 15 position 15."""
    ref, port, _ = runs
    pos = port["plan/hymba/decode_cache/layers/pos"]
    np.testing.assert_array_equal(pos, ref["hymba/decode_cache/layers/pos"])
    assert pos.shape[-1] == 16 and list(pos[0, [0, 1, 15]]) == [16, 1, 15]


def test_apply_moe_on_the_mesh_matches_reference(runs):
    """``apply_moe`` at (2, 2) with two routing groups, some slots
    dropped: the output and the Switch aux loss equal the reference's on
    its mesh and the port's unsharded call; each rank holds its half of
    the experts' weights."""
    ref, port, _ = runs
    assert int(port["moe/dropped"]) > 0
    _close(port["moe/y"], ref["moe/y"], 1e-5, "apply_moe output")
    _close(port["moe/y"], port["moe/plain_y"], 1e-6, "apply_moe, plain")
    _close(port["moe/aux"], ref["moe/aux"], 1e-6, "aux loss")
    _close(port["moe/aux"], port["moe/plain_aux"], 1e-7, "aux loss, plain")
    assert tuple(port["moe/wi_local"]) == (2, 32, 128)


def test_routing_and_scans_run_on_each_ranks_chunk(runs):
    """At (2, 2): each rank routes its own token group (1 of 2 groups of
    64 tokens), scans its 2 of 4 batch rows and 2 of 4 RWKV heads, and
    runs the Mamba scan on its 2 batch rows and 64 of d_inner's 128."""
    _, port, _ = runs
    assert tuple(port["local/_dispatch"]) == (1, 64, 64)
    assert tuple(port["local/rwkv_chunk_scan"]) == (2, 2, 24, 16)
    assert tuple(port["local/mamba_scan"]) == (2, 15, 64, 8)
