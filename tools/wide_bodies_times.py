"""Time the CAM head and flash attention's wide bodies, for source trees.

    python3 tools/wide_bodies_times.py [SRC ...]        # on a card

For each source tree (a directory holding ``repro_torch``; ``src`` by
default), in the order given and each in a process of its own, builds
its CAM head and flash attention libraries and times, by CUDA events
around 50 back-to-back calls (the least of 3 such windows):

- ``cam_head_bgd`` at the filter's (32, 3136, 256) features with C = 3,
  4, 8, 16 and 128 classes in float32, and at C = 8 and 128 on bf16
  features and weights, beside ``torch.matmul`` (TF32 off) on the same
  inputs and the bytes bound (features and w read once, the CAM and
  counts written once, at 3.35 TB/s); where the tree has
  ``cam_head.launch_body``, also each of its bodies forced, so that one
  tree gives both sides of the crossover;
- ``flash_attention_bhsd`` at (B, H, KV, S) = (4, 8, 8, 1024), causal,
  head dims 320, 384 and 512 in bf16 and 512 in float32, beside
  ``scaled_dot_product_attention`` (causal, TF32 off) and the bound
  (the larger of the bytes at 3.35 TB/s and the causal half of 4 B H
  S^2 hd at 989 TFLOP/s in bf16, three TF32 products a float32 one at
  495 TFLOP/s in float32).

Name two trees in turns (A B B A) to compare them on one card, say a
parent checkout unpacked by ``git archive`` under ``build/``.  Prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

CAM = (32, 3136, 256)                    # (B, P, D), the filter's grid 56
CAM_CLASSES = (3, 4, 8, 16, 128)         # float32
CAM_CLASSES_BF16 = (8, 128)              # bf16 features and weights
FLASH = (4, 8, 8, 1024)                  # (B, H, KV, S), causal
FLASH_HDS = ((320, "bfloat16"), (384, "bfloat16"), (512, "bfloat16"),
             (512, "float32"))
HBM = 3.35e12
PEAK = {"bfloat16": 989e12, "float32": 495e12 / 3}   # FLOP/s of the work


def times(src: str) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import cam_head as CH
    from repro_torch.kernels import flash_attention as FA
    build.build_all(["cam_head", "flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def window(fn, calls=50):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    def best(fn):
        return min(window(fn) for _ in range(3))

    B, P, D = CAM
    feat32 = torch.randn(B, P, D, generator=gen, device=dev)
    cases = [(C, torch.float32) for C in CAM_CLASSES] + [
        (C, torch.bfloat16) for C in CAM_CLASSES_BF16]
    for C, dt in cases:
        feat = feat32.to(dt)
        w = (torch.randn(D, C, generator=gen, device=dev) * 0.1).to(dt)
        b = torch.randn(C, generator=gen, device=dev) * 0.1
        esize = feat.element_size()
        n_bytes = (B * P * D + D * C) * esize + (C + B * P * C + B * C) * 4
        line = (f"{src}: cam_head (B, P, D, C) = ({B}, {P}, {D}, {C}) "
                f"{str(dt)[6:]}: cam_head_bgd {best(lambda: CH.cam_head_bgd(feat, w, b)):.4f} ms")
        for body in getattr(CH, "BODIES", ()):
            line += (f", {body} body "
                     f"{best(lambda: CH.launch_body(feat, w, b, body)):.4f}")
        line += (f"; torch.matmul {best(lambda: torch.matmul(feat, w)):.4f}"
                 f" ms; bound {n_bytes / HBM * 1e3:.4f} ms (bytes)")
        print(line, flush=True)
        del feat, w, b
    del feat32
    Bf, H, KV, S = FLASH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for hd, name in FLASH_HDS:
        dt = getattr(torch, name)
        q = torch.randn(Bf, H, S, hd, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(Bf, KV, S, hd, generator=gen, device=dev).to(dt)
                for _ in range(2))
        flops = 4 * Bf * H * S * S * hd / 2
        n_bytes = (2 * Bf * H * S * hd + 2 * Bf * KV * S * hd) * q.element_size()
        bound = max(flops / PEAK[name], n_bytes / HBM) * 1e3
        t = best(lambda: FA.flash_attention_bhsd(q, k, v, causal=True))
        ts = best(lambda: sdpa(q, k, v, is_causal=True))
        print(f"{src}: flash (B, H, KV, S, hd) = ({Bf}, {H}, {KV}, {S}, "
              f"{hd}) causal {name}: kernel {t:.4f} ms "
              f"({100 * bound / t:.1f}% of the {bound:.4f} ms bound), SDPA "
              f"{ts:.4f} ms", flush=True)
        del q, k, v


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("src", nargs="*", default=["src"])
    args = ap.parse_args(argv)
    if args.one:
        times(args.src[0])
        return 0
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for src in args.src:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", src]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
