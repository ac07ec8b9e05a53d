"""Dry-run analysis of the model zoo's steps on one card.

The JAX package's ``launch/dryrun.py`` lowers and compiles each (arch x
shape cell) step for a 256- or 512-chip mesh and reads XLA's memory and
cost analyses.  Here each step runs once on ``meta`` tensors (nothing is
allocated or computed) under ``launch.op_cost.OpCost``, which counts its
FLOPs, bytes, collectives and live storage bytes op by op, and the
record is laid out like the reference's so the two read side by side:
``mesh`` is ``"one-card"``, ``chips`` 1, ``analyse_s`` takes the place
of ``lower_s`` and ``compile_s``, and the roofline uses the H100 SXM's
published rates (``H100``).  On ``meta`` every kernel's plain version
stands in for it; ``kernel_calls`` counts those calls, which on the
card are the kernels' launches.

    python -m repro_torch.launch.dryrun --arch qwen2_0p5b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch

The reference's ``--mesh``, ``--rules`` and ``--decode-shardmap`` have no
counterpart yet: the mesh modules exist (``launch/mesh.py``,
``distributed/``, ``train/step.make_plan``), and the dry-run over a
mesh (per-rank peak and collectives from the plan's specs) is queued
(ROADMAP).  A large cell takes minutes of host time.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import op_cost as OC
from repro_torch.launch import specs as SPECS
from repro_torch.models import model as M
from repro_torch.models.config import (SHAPE_CELLS, shape_cell,
                                       supports_long_context)
from repro_torch.optim import adamw
from repro_torch.train import step as TS

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet): the
# tensor cores' bf16 / fp16 rate, float32 outside the tensor cores (the
# port keeps TF32 off), device memory and its rate, NVLink one way
H100 = {"bf16_flops": 989.4e12, "fp32_flops": 67e12, "hbm_bw": 3.35e12,
        "hbm_bytes": 80 * 2 ** 30, "nvlink_bw": 450e9}
DOT_PEAK = {"bfloat16": H100["bf16_flops"], "float16": H100["bf16_flops"]}


def cell_is_applicable(cfg, cell) -> Optional[str]:
    if cell.name == "long_500k" and not supports_long_context(cfg):
        return ("skip: long_500k needs sub-quadratic attention "
                "(full-attention arch)")
    return None


def roofline(cost: Dict[str, Any], cfg, cell) -> Dict[str, Any]:
    """Least times of the cell's step on one H100 from its counts: dot
    FLOPs at their dtype's peak and the rest at float32's, heavy bytes at
    the memory rate, collectives' wire bytes over NVLink; and the model
    FLOPs, (6 or 2) x N_active x tokens, against all FLOPs."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (6 if cell.kind == "train" else 2) * \
        cfg.active_param_count() * tokens
    dots = cost["dot_flops"]
    compute = sum(f / DOT_PEAK.get(dt, H100["fp32_flops"])
                  for dt, f in dots.items()) + \
        (cost["flops"] - sum(dots.values())) / H100["fp32_flops"]
    r = {"compute_s": compute,
         "memory_s": cost["bytes_heavy"] / H100["hbm_bw"],
         "memory_s_unfused_ceiling": cost["bytes"] / H100["hbm_bw"],
         "collective_s": cost["collectives"]["total"]["wire_bytes"]
         / H100["nvlink_bw"],
         "model_flops": model_flops,
         "useful_flops_frac": model_flops / max(cost["flops"], 1.0),
         "tokens": tokens}
    r["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: r[k])[:-2]
    return r


def analyse(cfg, cell) -> Dict[str, Any]:
    """Run the cell's step once on ``meta`` under ``OpCost``; returns
    the counts (``OpCost.summary``) with ``output_bytes``,
    ``new_output_bytes`` and ``kernel_calls``.  (On ``meta`` the
    initialisers draw nothing, so the generator does not matter.)"""
    gen = torch.Generator()
    inputs = SPECS.input_specs(cfg, cell)
    opt = None
    if cell.kind == "train":
        opt = adamw(1e-4, weight_decay=0.1)
        first = TS.init_state(gen, cfg, opt, device="meta")
    else:
        first = M.init_params(gen, cfg, device="meta")
    step = TS.step_for_cell(cfg, cell, opt)
    ops.reset_plain_counts()
    out, cost = OC.count(step, first, inputs, cache=inputs.get("cache"))
    got = cost.summary()
    got["output_bytes"] = OC.storage_bytes(OC.tensors(out))
    got["new_output_bytes"] = cost.new_bytes(out, (first, inputs))
    got["kernel_calls"] = {k: n for k, n in ops.plain_counts().items() if n}
    return got


def run_cell(arch: str, shape_name: str, remat: Optional[str] = None
             ) -> Dict[str, Any]:
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = shape_cell(shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "one-card", "chips": 1,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    skip = cell_is_applicable(cfg, cell)
    if skip:
        rec["status"] = skip
        return rec
    t0 = time.perf_counter()
    c = analyse(cfg, cell)
    temp = max(c["peak_bytes"] - c["argument_bytes"] - c["new_output_bytes"],
               0)
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
        "cost": {"flops_global": c["flops"],
                 "dot_flops": c["dot_flops"],
                 "bytes_heavy_global": c["bytes_heavy"],
                 "bytes_unfused_ceiling_global": c["bytes"]},
        "collectives": c["collectives"] if len(c["collectives"]) > 1 else {},
        "roofline": roofline(c, cfg, cell),
        "kernel_calls": c["kernel_calls"],
        "ops": c["ops"],
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run analysis of the zoo's steps on one card (meta "
                    "tensors; H100 SXM roofline).  The JAX package's "
                    "--mesh, --rules and --decode-shardmap have no "
                    "counterpart: one card has no mesh, no sharding rules "
                    "and no sequence-sharded decode.")
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape cell)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--remat", default=None,
                    help="none | full | selective (default: the config's)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s.name) for a in ARCHS for s in SHAPE_CELLS]
             if args.all else [(args.arch, args.shape)])
    for arch, shape in cells:
        name = f"{arch}__{shape}__one-card"
        if args.tag:
            name += f"__{args.tag}"
        try:
            rec = run_cell(arch, shape, remat=args.remat)
        except Exception as e:      # recorded; the sweep goes on
            rec = {"arch": arch, "shape": shape, "mesh": "one-card",
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
