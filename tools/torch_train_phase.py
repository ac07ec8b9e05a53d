"""Run ``chip_smoke.py``'s training phase alone, in a fresh process.

    python3 tools/torch_train_phase.py              # on a CUDA card
    python3 tools/torch_train_phase.py --rehearse   # tiny, on the CPU

Builds the kernels (decode attention serves the trained checkpoint),
then runs ``zoo_training_phase`` and prints its lines after the card's
name and power limit: the same checks and numbers as the smoke's phase
17, without the phases that run before it in the smoke's process.
Exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        cs.check(torch.cuda.is_available(), "torch finds no CUDA device")
        dev = torch.device("cuda")
        print(cs.gpu_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all()
        print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, lines = cs.zoo_training_phase(torch, dev, args.rehearse)
    for line in lines:
        print(line, flush=True)
    print(f"launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
