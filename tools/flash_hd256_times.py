"""Time bf16 flash attention at head dim 256 beside SDPA, for source trees.

    python3 tools/flash_hd256_times.py [SRC ...]      # on a CUDA card

For each source tree (a directory holding ``repro_torch``; ``src`` by
default), in the order given and each in a process of its own, builds
its kernels and times ``flash_attention_bhsd`` in bfloat16 at head dim
256, 8 heads over one kv head, at paligemma-3b's (8, 8, 1, 1024, 256)
causal and not, and at (2, ..., 4096) and (1, ..., 8192) causal, beside
``scaled_dot_product_attention`` (causal, GQA) on the same inputs: CUDA
events around 50 back-to-back calls, the least of 3 such windows, with
the TFLOP/s that the work (the causal half of 4 B H S^2 hd where causal)
makes of it.  Name two trees in turns (A B B A) to compare them on one
card.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

SHAPES = ((8, 1024, True), (8, 1024, False), (2, 4096, True),
          (1, 8192, True))               # (B, S, causal) at H 8, KV 1


def times(src: str) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    build.build_all(["flash_attention"])
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention

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

    for B, S, causal in SHAPES:
        q = torch.randn(B, 8, S, 256, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, 1, S, 256, generator=gen, device=dev
                            ).bfloat16() for _ in range(2))
        flops = 4 * B * 8 * S * S * 256 / (2 if causal else 1)
        t = min(window(lambda: FA.flash_attention_bhsd(q, k, v,
                                                       causal=causal))
                for _ in range(3))
        ts = min(window(lambda: sdpa(q, k, v, is_causal=causal,
                                     enable_gqa=True)) for _ in range(3))
        print(f"{src}: (B, H, KV, S, hd) = ({B}, 8, 1, {S}, 256) causal="
              f"{causal}: body {t:.4f} ms ({flops / t / 1e9:.0f} TFLOP/s), "
              f"SDPA {ts:.4f} ms ({flops / ts / 1e9:.0f} TFLOP/s)",
              flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        times(argv[1])
        return 0
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for src in argv or ["src"]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", src]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
