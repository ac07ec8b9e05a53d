"""Run one late phase of ``chip_smoke.py`` alone, in a fresh process.

    python3 tools/torch_smoke_phase.py train             # on a CUDA card
    python3 tools/torch_smoke_phase.py launch --rehearse # tiny, on the CPU
    python3 tools/torch_smoke_phase.py mesh              # on a CUDA card
    python3 tools/torch_smoke_phase.py families          # on a CUDA card
    python3 tools/torch_smoke_phase.py fleet             # on a CUDA card
    python3 tools/torch_smoke_phase.py flash256          # on a CUDA card
    python3 tools/torch_smoke_phase.py decode256         # on a CUDA card
    python3 tools/torch_smoke_phase.py paligemma         # on a CUDA card
    python3 tools/torch_smoke_phase.py decode256 --root build/parent

``train`` is the smoke's phase 17 (``zoo_training_phase``), ``launch``
its phase 19 (``launch_phase``: the launch analyses against steps on
the card, and gradient compression), ``mesh`` its phase 20
(``mesh_phase``: the sharding plan at world 1 over NCCL, four ranks on
the one card over gloo), ``families`` its phase 21 (``families_phase``:
every family's serving through the plan at world 1, four ranks at (2,
2) on the one card over gloo, the mesh dry-run beside them), ``fleet``
its phases 2 and 5c (the filter's training and the one-card fleet) and
then 22 (``fleet_mesh_phase``: the fleet over a stream mesh of one rank
over NCCL, then four ranks on the one card over gloo), ``flash256`` its
phase 23 (``flash256_phase``: flash attention at head dim 256 and a
padded 96, paligemma-3b's tokens-only forward under ``pallas``,
``ops.spatial_stats`` and the monitoring-queries twin), ``decode256``
its phase 16 (``decode256_entry``: decode attention at head dim 256 on
(128, 1, 8, 32768, 256) at kv_len 30000, the bf16 body's report, SDPA
and the bound beside it, NaN past kv_len, float32), ``paligemma`` its
phase 14's paligemma-3b serving (``family_serving_phase``: profiles of
a decode step and a prefill, 32 greedy steps, layer 0's decode call
against plain).  ``--root`` runs the phase from another checkout (say a
parent commit unpacked by ``git archive``), its ``chip_smoke.py`` and
``src/`` both.  Builds the
kernels (decode attention runs in both), then runs the phase and prints
its lines after
the card's name and power limit: the same checks and numbers as in the
smoke, without the phases that run before it in the smoke's process.
Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fleet(torch, dev, rehearse, gpu):
    """The smoke's phases 2, 5c and 22: train the filter, serve the fleet
    on one card, then over the stream mesh."""
    import dataclasses

    import chip_smoke as cs
    scene, trunk, spec = cs.configure(rehearse)
    tf, lines = cs.training_phase(torch, dev, scene, trunk, spec, rehearse)
    serve = dataclasses.replace(
        tf, trunk_cfg=dataclasses.replace(trunk, attn_impl="pallas"))
    cs.save_filter(torch, serve, cs.fleet_filter_path())
    more, _, ref = cs.fleet_phase(torch, dev, scene, serve, gpu, rehearse)
    for line in lines + more:
        print(line, flush=True)
    del tf, serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return cs.fleet_mesh_phase(torch, dev, scene, ref, gpu, rehearse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=["train", "launch", "mesh", "families",
                                      "fleet", "flash256", "decode256",
                                      "paligemma"])
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--root", default=os.path.join(HERE, ".."),
                    help="the checkout whose chip_smoke.py and src/ run "
                         "(another commit's, unpacked, to compare two on "
                         "one card; this one's by default)")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(args.root, "src"), args.root]
    import torch

    import chip_smoke as cs
    if args.rehearse:
        dev, gpu = torch.device("cpu"), "CPU rehearsal"
    else:
        cs.check(torch.cuda.is_available(), "torch finds no CUDA device")
        dev, gpu = torch.device("cuda"), cs.gpu_line()
        print(gpu, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.phase == "train":
        launches, lines = cs.zoo_training_phase(torch, dev, args.rehearse)
    elif args.phase == "mesh":
        launches, lines = None, cs.mesh_phase(torch, dev, args.rehearse, gpu)
    elif args.phase == "families":
        launches, lines = cs.families_phase(torch, dev, args.rehearse, gpu)
    elif args.phase == "fleet":
        launches, lines = fleet(torch, dev, args.rehearse, gpu)
    elif args.phase == "flash256":
        scene, _, _ = cs.configure(args.rehearse)
        entry, launches, lines = cs.flash256_phase(torch, dev, scene,
                                                   args.rehearse, gpu)
        lines.append(json.dumps({"hd256": entry}))
    elif args.phase == "decode256":
        from repro_torch.kernels import ops
        timer, ktimer = cs.timers(torch, args.rehearse)
        entry, lines = cs.decode256_entry(torch, dev, timer, ktimer,
                                          args.rehearse)
        launches = ops.launch_counts()
        lines.append(json.dumps({"hd256": entry}))
    elif args.phase == "paligemma":
        launches, lines = cs.family_serving_phase(torch, dev, args.rehearse,
                                                  "paligemma")
    else:
        launches, lines = cs.launch_phase(torch, dev, args.rehearse, gpu)
    for line in lines:
        print(line, flush=True)
    print(f"launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
