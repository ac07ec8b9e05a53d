"""Dry-run analysis of the model zoo's steps: on one card, or per rank on
the production meshes.

The JAX package's ``launch/dryrun.py`` lowers and compiles each (arch x
shape cell) step for a 256- or 512-chip mesh and reads XLA's memory and
cost analyses.  Here each step runs once on ``meta`` tensors (nothing is
allocated or computed) under ``launch.op_cost.OpCost``, which counts its
FLOPs, bytes, collectives and live storage bytes op by op, and the
record is laid out like the reference's so the two read side by side:
``analyse_s`` takes the place of ``lower_s`` and ``compile_s``, and the
roofline uses the H100 SXM's published rates (``H100``).  On ``meta``
every kernel's plain version stands in for it; ``kernel_calls`` counts
those calls, which on the card are the kernels' launches.

``--mesh one-card`` (the default) runs the unsharded step
(``train/step.step_for_cell``): ``mesh`` is ``"one-card"``, ``chips`` 1.
``--mesh single`` / ``multi`` / ``both`` run the sharded step
(``jit_step_for_cell``) on the (16, 16) ("data", "model") mesh of 256
ranks and the (2, 16, 16) ("pod", "data", "model") mesh of 512, in this
one process: ``launch.mesh.init_fake`` starts torch's fake process group
of that size, the plan's state and inputs are placed as DTensors of
``meta`` chunks, and ``OpCost`` counts what rank 0 runs and holds
(``memory`` is per rank, ``fits_hbm`` against one H100's 80 GiB;
``cost.flops_global`` is the rank's FLOPs times the ranks, which counts
replicated work on every rank; the collectives by op and by mesh axis).
``--rules`` takes the sharding-rule overrides as JSON
(``distributed.sharding.make_rules``) and ``--decode-shardmap`` runs
the step under ``ctx.decode_shard(mesh)`` (the sequence-sharded decode
attention), as the reference's ``run_cell`` does.

    python -m repro_torch.launch.dryrun --arch qwen2_0p5b --shape decode_32k
    python -m repro_torch.launch.dryrun --arch qwen2_72b --shape train_4k \
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both \
        --out results/dryrun_torch

A large cell takes minutes of host time; a mesh record's names are
``{arch}__{shape}__{single|multi}.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import ctx
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.launch import mesh as MESH
from repro_torch.launch import op_cost as OC
from repro_torch.launch import specs as SPECS
from repro_torch.models import model as M
from repro_torch.models.config import (SHAPE_CELLS, shape_cell,
                                       supports_long_context)
from repro_torch.optim import adamw
from repro_torch.train import step as TS

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet): the
# tensor cores' bf16 / fp16 rate, float32 outside the tensor cores (the
# port keeps TF32 off), device memory and its rate, NVLink one way (900
# GB/s both ways).  Across nodes (NVIDIA's DGX H100 data sheet: 8 cards a
# node, each with its own 400 Gb/s NDR InfiniBand port): 50 GB/s a card.
H100 = {"bf16_flops": 989.4e12, "fp32_flops": 67e12, "hbm_bw": 3.35e12,
        "hbm_bytes": 80 * 2 ** 30, "nvlink_bw": 450e9, "ib_bw": 50e9,
        "node_cards": 8}
DOT_PEAK = {"bfloat16": H100["bf16_flops"], "float16": H100["bf16_flops"]}
MESHES = {"one-card": 1, "single": 256, "multi": 512}


def cell_is_applicable(cfg, cell) -> Optional[str]:
    if cell.name == "long_500k" and not supports_long_context(cfg):
        return ("skip: long_500k needs sub-quadratic attention "
                "(full-attention arch)")
    return None


def axis_bandwidth(mesh) -> Dict[str, float]:
    """{mesh axis: the rate one rank sends at over it}: NVLink where each
    of the axis's groups lies within one node of ``H100["node_cards"]``
    consecutive ranks, InfiniBand where a group spans nodes."""
    ranks = mesh.mesh
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        nodes = (ranks.movedim(i, -1).reshape(-1, ranks.shape[i])
                 // H100["node_cards"])
        one = bool((nodes == nodes[:, :1]).all())
        out[name] = H100["nvlink_bw"] if one else H100["ib_bw"]
    return out


def roofline(cost: Dict[str, Any], cfg, cell,
             bandwidth: Optional[Dict[str, float]] = None
             ) -> Dict[str, Any]:
    """Least times of the cell's step on one H100 (on a mesh: one rank)
    from its counts: dot FLOPs at their dtype's peak and the rest at
    float32's, heavy bytes at the memory rate, collectives' wire bytes
    over NVLink (on a mesh: each at its axis's ``bandwidth``); and the
    model FLOPs, (6 or 2) x N_active x tokens of the whole step, against
    all FLOPs (on a mesh: against ``flops_global``)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (6 if cell.kind == "train" else 2) * \
        cfg.active_param_count() * tokens
    dots = cost["dot_flops"]
    compute = sum(f / DOT_PEAK.get(dt, H100["fp32_flops"])
                  for dt, f in dots.items()) + \
        (cost["flops"] - sum(dots.values())) / H100["fp32_flops"]
    if bandwidth is None:
        coll = cost["collectives"]["total"]["wire_bytes"] / H100["nvlink_bw"]
        flops = cost["flops"]
    else:
        coll = sum(v["wire_bytes"] / bandwidth[k.split(" over ")[1]]
                   for k, v in cost["collectives_by_axis"].items()
                   if k != "total")
        flops = cost["flops"] * cost["ranks"]
    r = {"compute_s": compute,
         "memory_s": cost["bytes_heavy"] / H100["hbm_bw"],
         "memory_s_unfused_ceiling": cost["bytes"] / H100["hbm_bw"],
         "collective_s": coll,
         "model_flops": model_flops,
         "useful_flops_frac": model_flops / max(flops, 1.0),
         "tokens": tokens}
    r["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: r[k])[:-2]
    return r


def analyse(cfg, cell, mesh=None, rules=None, decode_shardmap: bool = False,
            inputs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run the cell's step once on ``meta`` under ``OpCost``; returns
    the counts (``OpCost.summary``) with ``output_bytes``,
    ``new_output_bytes`` and ``kernel_calls``.  (On ``meta`` the
    initialisers draw nothing, so the generator does not matter.)

    With a ``mesh`` the step is ``jit_step_for_cell``'s under ``rules``
    (and ``ctx.decode_shard(mesh)`` with ``decode_shardmap``), its state
    and inputs placed as DTensors before the count, and every count is
    the rank's own.  ``inputs`` (meta tensors in ``input_specs``' tree)
    replace the cell's where a step runs on others, such as a prompt
    shorter than its cache."""
    gen = torch.Generator()
    opt = adamw(1e-4, weight_decay=0.1) if cell.kind == "train" else None
    if inputs is None:
        inputs = SPECS.input_specs(cfg, cell)
    if mesh is None:
        if opt is not None:
            first = TS.init_state(gen, cfg, opt, device="meta")
        else:
            first = M.init_params(gen, cfg, device="meta")
        step = TS.step_for_cell(cfg, cell, opt)
    else:
        step, plan = TS.jit_step_for_cell(cfg, cell, mesh, opt, rules=rules)
        first = plan.place(plan.abstract_state, plan.state_shardings
                           if opt is not None else plan.param_shardings)
        inputs = plan.place_inputs(inputs)
    ops.reset_plain_counts()
    shard = ctx.decode_shard(mesh) if decode_shardmap else \
        contextlib.nullcontext()
    with shard:
        out, cost = OC.count(step, first, inputs, cache=inputs.get("cache"),
                             mesh=mesh)
    got = cost.summary()
    got["ranks"] = 1 if mesh is None else mesh.size()
    got["output_bytes"] = OC.storage_bytes(OC.tensors(out))
    got["new_output_bytes"] = cost.new_bytes(out, (first, inputs))
    got["kernel_calls"] = {k: n for k, n in ops.plain_counts().items() if n}
    return got


def production_mesh(mesh: str):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over a fake process
    group of its size, in this process (``launch.mesh.init_fake``)."""
    MESH.init_fake(MESHES[mesh])
    return MESH.make_production_mesh(multi_pod=mesh == "multi")


def run_cell(arch: str, shape_name: str, remat: Optional[str] = None,
             mesh: str = "one-card", rules: Optional[Dict[str, Any]] = None,
             decode_shardmap: bool = False) -> Dict[str, Any]:
    """One cell's record on one card or, with ``mesh`` "single" /
    "multi", per rank of the production mesh under the rule overrides
    ``rules``."""
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = shape_cell(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "chips": MESHES[mesh],
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    skip = cell_is_applicable(cfg, cell)
    if skip:
        rec["status"] = skip
        return rec
    t0 = time.perf_counter()
    dm = None if mesh == "one-card" else production_mesh(mesh)
    c = analyse(cfg, cell, dm, SH.make_rules(rules) if rules else None,
                decode_shardmap)
    temp = max(c["peak_bytes"] - c["argument_bytes"] - c["new_output_bytes"],
               0)
    if dm is None:
        cost = {"flops_global": c["flops"],
                "dot_flops": c["dot_flops"],
                "bytes_heavy_global": c["bytes_heavy"],
                "bytes_unfused_ceiling_global": c["bytes"]}
    else:
        rec.update({"rules": rules or {}, "decode_shardmap": decode_shardmap})
        cost = {"flops_per_rank": c["flops"],
                "flops_global": c["flops"] * c["ranks"],
                "flops_global_note": "flops_per_rank x chips: work that "
                                     "DTensor replicates is counted on "
                                     "every rank",
                "dot_flops_per_rank": c["dot_flops"],
                "bytes_heavy_per_rank": c["bytes_heavy"],
                "bytes_unfused_ceiling_per_rank": c["bytes"]}
    colls = c["collectives"] if len(c["collectives"]) > 1 else {}
    rec.update({
        "status": "ok",
        "remat": cfg.remat,
        "analyse_s": round(time.perf_counter() - t0, 1),
        "memory": {
            "argument_bytes": c["argument_bytes"],
            "output_bytes": c["output_bytes"],
            "temp_bytes": temp,
            "peak_bytes": c["peak_bytes"],
            "fits_hbm": c["peak_bytes"] < H100["hbm_bytes"],
        },
        "cost": cost,
        "collectives": colls,
        "roofline": roofline(c, cfg, cell,
                             None if dm is None else axis_bandwidth(dm)),
        "kernel_calls": c["kernel_calls"],
        "ops": c["ops"],
    })
    if dm is not None:
        rec["collectives_by_axis"] = c["collectives_by_axis"] if colls \
            else {}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run analysis of the zoo's steps (meta tensors; "
                    "H100 SXM roofline): on one card, or per rank of the "
                    "production meshes over a fake process group.")
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape cell)")
    ap.add_argument("--mesh", choices=["one-card", "single", "multi", "both"],
                    default="one-card",
                    help="one-card: the unsharded step (default); single: "
                         "the (16, 16) mesh of 256 ranks; multi: the (2, 16, "
                         "16) mesh of 512; both: single and multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--remat", default=None,
                    help="none | full | selective (default: the config's)")
    ap.add_argument("--rules", default=None,
                    help="JSON sharding-rule overrides (a mesh only), e.g. "
                         "'{\"expert_embed\": null}'")
    ap.add_argument("--decode-shardmap", action="store_true",
                    help="run the step under ctx.decode_shard: the "
                         "sequence-sharded decode attention (a mesh only)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    # DTensor's advice on sequential collectives, once per redistribute
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.mesh == "one-card" and (args.rules or args.decode_shardmap):
        ap.error("--rules and --decode-shardmap need --mesh")

    os.makedirs(args.out, exist_ok=True)
    meshes = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    overrides = json.loads(args.rules) if args.rules else None
    cells = ([(a, s.name) for a in ARCHS for s in SHAPE_CELLS]
             if args.all else [(args.arch, args.shape)])
    for arch, shape in cells:
        for mesh in meshes:
            name = f"{arch}__{shape}__{mesh}"
            if args.tag:
                name += f"__{args.tag}"
            try:
                if mesh == "one-card":
                    rec = run_cell(arch, shape, remat=args.remat)
                else:
                    rec = run_cell(arch, shape, remat=args.remat, mesh=mesh,
                                   rules=overrides,
                                   decode_shardmap=args.decode_shardmap)
            except Exception as e:      # recorded; the sweep goes on
                rec = {"arch": arch, "shape": shape, "mesh": mesh,
                       "status": f"ERROR: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            with open(os.path.join(args.out, name + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            status = rec.get("status", "?")
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" compute={r['compute_s'] * 1e3:.1f}ms "
                         f"mem={r['memory_s'] * 1e3:.1f}ms "
                         f"coll={r['collective_s'] * 1e3:.1f}ms "
                         f"dom={r['bottleneck']} "
                         f"peak={rec['memory']['peak_bytes'] / 2 ** 30:.1f}GiB "
                         f"analyse={rec['analyse_s']:.0f}s")
            print(f"[dryrun] {name}: {status[:80]}{extra}", flush=True)


if __name__ == "__main__":
    main()
