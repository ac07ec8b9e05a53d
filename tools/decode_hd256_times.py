"""Time bf16 decode attention at head dim 256 beside SDPA, for source trees.

    python3 tools/decode_hd256_times.py [SRC ...]     # on a CUDA card

For each source tree (a directory holding ``repro_torch``; ``src`` by
default), in the order given and each in a process of its own, builds
its decode attention kernel and times ``decode_attention_bkgd`` in
bfloat16 at head dim 256, 8 query heads over one kv head (paligemma-3b's
group), on a (B, S, KV, hd) cache read in place with ``kv_len`` on the
device: B 128 at kv_len 30,000 (the smoke's phase 16), B 8 and 32 at
8,192 and 30,000 (S 32,768), and paligemma-3b's own decode step (B 8, a
352-row cache at kv_len 330), beside ``scaled_dot_product_attention``
on the ``kv_len`` slice of a contiguous (B, KV, S, hd) copy; then the
bodies at the other head dims and in float32 (``OTHERS``: decode_32k's
hd 64 bf16 shape, hd 128 bf16, hd 64 and 256 in float32) alone.  Times
are CUDA events around 50 back-to-back calls, the least of 3 such
windows; at hd 256 in bf16 also the rate that the bytes the work must
move (each valid k and v row, q and o once) make of it, and the median
of 101 single calls (``call``: the device time plus what the host adds
to one call).  Name two trees in turns (A B B A)
to compare them on one card.  Prints the card's name and power limit
first.
"""
from __future__ import annotations

import os
import subprocess
import sys

SHAPES = ((128, 32768, 30000), (8, 32768, 8192), (8, 32768, 30000),
          (32, 32768, 8192), (32, 32768, 30000), (8, 352, 330))
G, HD = 8, 256                   # (B, S, kv_len) at KV 1
# (B, KV, G, S, hd, dtype, kv_len) of the other bodies
OTHERS = ((128, 2, 7, 32768, 64, "bfloat16", 30000),
          (32, 2, 8, 32768, 128, "bfloat16", 30000),
          (32, 2, 7, 8192, 64, "float32", 8000),
          (8, 1, 8, 4096, 256, "float32", 3001))


def times(src: str) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    build.build_all(["decode_attention"])
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

    def call(fn, reps=101):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return sorted(out)[reps // 2]

    for B, S, kv_len in SHAPES:
        q = torch.randn(B, 1, G, HD, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, S, 1, HD, generator=gen, device=dev
                            ).bfloat16() for _ in range(2))
        kt, vt = (t.transpose(1, 2) for t in (k, v))
        length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        ks, vs = (t.transpose(1, 2)[:, :, :kv_len].contiguous()
                  for t in (k, v))
        n_bytes = 2 * B * kv_len * HD * 2 + 2 * B * G * HD * 2

        def body():
            return DA.decode_attention_bkgd(q, kt, vt, length)

        def lib():
            return sdpa(q, ks, vs)

        t = min(window(body) for _ in range(3))
        ts = min(window(lib) for _ in range(3))
        print(f"{src}: (B, KV, G, S, hd) = ({B}, 1, {G}, {S}, {HD}) kv_len "
              f"{kv_len}: body {t:.4f} ms ({n_bytes / t / 1e6:.0f} GB/s), "
              f"call {call(body):.4f} ms; SDPA on the kv_len slice "
              f"{ts:.4f} ms ({n_bytes / ts / 1e6:.0f} GB/s); bound "
              f"{n_bytes / 3.35e12 * 1e3:.4f} ms (bytes at 3.35 TB/s)",
              flush=True)
        del q, k, v, kt, vt, ks, vs
    for B, KV, G_, S, hd, dt, kv_len in OTHERS:
        dtype = getattr(torch, dt)
        q = torch.randn(B, KV, G_, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, KV, hd, generator=gen, device=dev
                            ).to(dtype).transpose(1, 2) for _ in range(2))
        length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        t = min(window(lambda: DA.decode_attention_bkgd(q, k, v, length))
                for _ in range(3))
        print(f"{src}: (B, KV, G, S, hd) = ({B}, {KV}, {G_}, {S}, {hd}) "
              f"{dt} kv_len {kv_len}: body {t:.4f} ms", flush=True)
        del q, k, v


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
