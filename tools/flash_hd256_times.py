"""Time flash attention at head dim 256 beside SDPA, for source trees.

    python3 tools/flash_hd256_times.py [--dtype float32] [SRC ...]   # on a card

For each source tree (a directory holding ``repro_torch``; ``src`` by
default), in the order given and each in a process of its own, builds
its kernels and times ``flash_attention_bhsd`` at head dim 256 in
bfloat16 (the default) or float32, 8 heads over one kv head, at
paligemma-3b's (8, 8, 1, 1024, 256) causal and not, and at (2, ...,
4096) and (1, ..., 8192) causal, beside ``scaled_dot_product_attention``
(causal, GQA) on the same inputs: CUDA events around 50 back-to-back
calls, the least of 3 such windows, with the TFLOP/s that the work (the
causal half of 4 B H S^2 hd where causal) makes of it and the share of
the bound that the time reaches (the work at 989 TFLOP/s in bf16, three
TF32 products for each fp32 one at 495 TFLOP/s in float32).  In float32
TF32 is off for SDPA (``allow_tf32`` False), as the port's float32 runs
it.  ``--others`` also times the other bodies the same way: float32 hd
32 at the filter trunk's (32, 4, 4, 3136, 32), not causal, and hd 64 and
128 in both types at (8, 8, 1, 1024, hd), causal.  Name two trees in
turns (A B B A) to compare them on one card.  Prints the card's name and
power limit first.

    python3 tools/flash_hd256_times.py --sass A B       # on a card

builds both trees' flash attention library and says, for each kernel
function the two share, whether its SASS (``cuobjdump -sass``) is the
same instruction for instruction (the file's hash in the names aside).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPES = ((8, 1024, True), (8, 1024, False), (2, 4096, True),
          (1, 8192, True))               # (B, S, causal) at H 8, KV 1
# --others: (B, H, KV, S, hd, dtype, causal)
OTHERS = ((32, 4, 4, 3136, 32, "float32", False),
          (8, 8, 1, 1024, 64, "bfloat16", True),
          (8, 8, 1, 1024, 64, "float32", True),
          (8, 8, 1, 1024, 128, "bfloat16", True),
          (8, 8, 1, 1024, 128, "float32", True))
PEAK = {"bfloat16": 989e12, "float32": 495e12 / 3}   # FLOP/s of the work


def times(src: str, dtype: str, others: bool) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    build.build_all(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
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

    cases = [(B, 8, 1, S, 256, dtype, causal) for B, S, causal in SHAPES]
    for B, H, KV, S, hd, name, causal in cases + list(OTHERS if others
                                                      else ()):
        dt = getattr(torch, name)
        q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, KV, S, hd, generator=gen, device=dev).to(dt)
                for _ in range(2))
        flops = 4 * B * H * S * S * hd / (2 if causal else 1)
        t = min(window(lambda: FA.flash_attention_bhsd(q, k, v,
                                                       causal=causal))
                for _ in range(3))
        ts = min(window(lambda: sdpa(q, k, v, is_causal=causal,
                                     enable_gqa=True)) for _ in range(3))
        bound = flops / PEAK[name] * 1e3
        print(f"{src}: {name} (B, H, KV, S, hd) = ({B}, {H}, {KV}, {S}, "
              f"{hd}) causal={causal}: body {t:.4f} ms ({flops / t / 1e9:.0f}"
              f" TFLOP/s, {100 * bound / t:.1f}% of the {bound:.4f} ms "
              f"bound), SDPA {ts:.4f} ms ({flops / ts / 1e9:.0f} TFLOP/s)",
              flush=True)
        del q, k, v


def sass(a: str, b: str) -> int:
    """Compare the SASS of each kernel function of two trees' flash
    attention libraries; 1 if a function both have differs."""
    import re

    funcs = []
    for src in (a, b):
        sys.path.insert(0, os.path.abspath(src))
        for mod in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[mod]
        from repro_torch.kernels import build
        path = build.build_all(["flash_attention"])["flash_attention"]
        tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        out = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True, check=True).stdout
        sys.path.pop(0)
        by_name = {}
        for f in out.split("Function : ")[1:]:
            head, body = f.split("\n", 1)
            hashed = r"_GLOBAL__N__[0-9a-f]{8}_\d+_flash_attention_cu_[0-9a-f]{8}"
            by_name[re.sub(hashed, "", head.strip())] = re.sub(hashed, "",
                                                               body)
        funcs.append(by_name)
    rc = 0
    for name in sorted(set(funcs[0]) | set(funcs[1])):
        if name not in funcs[0] or name not in funcs[1]:
            where = a if name in funcs[0] else b
            print(f"SASS {name}: only in {where}")
            continue
        same = funcs[0][name] == funcs[1][name]
        rc |= not same
        print(f"SASS {name}: {'identical' if same else 'DIFFERS'} "
              f"({funcs[0][name].count(chr(10))} lines)")
    return rc


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(PEAK), default="bfloat16")
    ap.add_argument("--others", action="store_true",
                    help="also time the hd 32, 64 and 128 bodies")
    ap.add_argument("--sass", action="store_true",
                    help="compare two trees' SASS, function by function")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("src", nargs="*", default=["src"])
    args = ap.parse_args(argv)
    if args.sass:
        if len(args.src) != 2:
            ap.error("--sass takes two trees")
        return sass(*args.src)
    if args.one:
        times(args.src[0], args.dtype, args.others)
        return 0
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for src in args.src:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", "--dtype", args.dtype, src]
                             + (["--others"] if args.others else [])
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
