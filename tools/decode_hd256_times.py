"""Time decode attention at head dim 256 beside SDPA, for source trees.

    python3 tools/decode_hd256_times.py [--dtype D] [--others] [SRC ...]
    python3 tools/decode_hd256_times.py --shapes [SRC ...]

On a CUDA card.  For each source tree (a directory holding
``repro_torch``; ``src`` by default), in the order given and each in a
process of its own, builds its decode attention kernel and times
``decode_attention_bkgd`` at head dim 256, 8 query heads over one kv head
(paligemma-3b's group), with ``kv_len`` on the device: in bfloat16
(``--dtype bfloat16`` or ``both``, the default) B 128 at kv_len 30,000
(the smoke's phase 16), B 8 and 32 at 8,192 and 30,000 (S 32,768) and
paligemma-3b's own decode step (B 8, a 352-row cache at kv_len 330), on a
(B, S, KV, hd) cache read in place; in float32 (``--dtype float32`` or
``both``) B 8 on a (B, KV, S, hd) cache of 4,096 rows at kv_len 3,001 and
of 352 rows at 330 (the smoke's phase 16), and B 128 at 30,000 on a
(B, S, KV, hd) cache read in place.  Beside each: the rate that the bytes
the work must move (each valid k and v row, q and o once) make of the
time, the bytes bound at 3.35 TB/s, and ``scaled_dot_product_attention``
on the ``kv_len`` slice of a contiguous (B, KV, S, hd) copy (TF32 off).
``--others`` also times the bodies at the other head dims the same way
(``OTHERS``: decode_32k's hd 64 shape in bf16 and float32, hd 128 in
both types).  ``--shapes`` times only ``WIDE``, the shapes of the smoke's
phase 24 (the zoo smoke configs' hd 16 at decode_32k's batch and length,
71 query heads over one kv head at hd 64, float32 hd 512) and 33 heads
over one (a half-empty block of the rows body).  Times are CUDA events
around 50 back-to-back calls, the
least of 3 such windows (``body``; at a small shape this is the host's
time a call), the device time a call from torch.profiler (the body and
the merge, or SDPA's kernels), the median of 101 single calls
(``call``: the device time plus what the host adds to one call), and
the plain version over 5 back-to-back calls.  Name two trees in turns
(A B B A) to compare them on one card.  Prints the card's name and
power limit first.

    python3 tools/decode_hd256_times.py --sass A B       # on a card

builds both trees' decode attention library and says, for each kernel
function the two share, whether its SASS (``cuobjdump -sass``) is the
same instruction for instruction (the file's hash in the names aside).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

G, HD = 8, 256
# (dtype, B, S, kv_len, cache layout) at KV 1, G 8, hd 256: "bskd" the
# model's (B, S, KV, hd) cache read in place, "bksd" a contiguous one
SHAPES = (("bfloat16", 128, 32768, 30000, "bskd"),
          ("bfloat16", 8, 32768, 8192, "bskd"),
          ("bfloat16", 8, 32768, 30000, "bskd"),
          ("bfloat16", 32, 32768, 8192, "bskd"),
          ("bfloat16", 32, 32768, 30000, "bskd"),
          ("bfloat16", 8, 352, 330, "bskd"),
          ("float32", 8, 4096, 3001, "bksd"),
          ("float32", 8, 352, 330, "bksd"),
          ("float32", 128, 32768, 30000, "bskd"))
# --others: (B, KV, G, S, hd, dtype, kv_len), on the (B, S, KV, hd) cache
OTHERS = ((128, 2, 7, 32768, 64, "bfloat16", 30000),
          (32, 2, 8, 32768, 128, "bfloat16", 30000),
          (32, 2, 7, 8192, 64, "float32", 8000),
          (32, 2, 8, 32768, 128, "float32", 30000))
# --shapes: (B, KV, G, S, hd, dtype, kv_len), on the (B, S, KV, hd) cache
WIDE = ((128, 2, 7, 32768, 16, "bfloat16", 30000),
        (128, 1, 71, 32768, 64, "bfloat16", 30000),
        (128, 1, 33, 32768, 64, "bfloat16", 30000),
        (8, 1, 8, 4096, 512, "float32", 3001))
HBM = 3.35e12                    # bytes/s


def times(src: str, dtypes: tuple, others: bool, wide: bool) -> None:
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    build.build_all(["decode_attention"])
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

    def device(fn, calls=25, tries=5):
        """Device ms a call from torch.profiler: each kernel's mean over
        its recorded launches times its launches a call (the profiler may
        miss some of a window's launches), and the merge kernel's share
        of it; nan if no window records."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        for _ in range(tries):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count > 0
                    and e.self_device_time_total > 0]
            if kern:
                least = min(e.count for e in kern)
                ms = {e.key: e.self_device_time_total / e.count
                      * round(e.count / least) / 1e3 for e in kern}
                return sum(ms.values()), sum(t for k, t in ms.items()
                                             if "merge" in k)
        return float("nan"), float("nan")

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

    cases = [(B, 1, G, S, HD, dt, kv_len, layout)
             for dt, B, S, kv_len, layout in SHAPES if dt in dtypes
             and not wide]
    cases += [(*c, "bskd") for c in (OTHERS if others else ())]
    cases += [(*c, "bskd") for c in (WIDE if wide else ())]
    for B, KV, G_, S, hd, dt, kv_len, layout in cases:
        dtype = getattr(torch, dt)
        q = torch.randn(B, KV, G_, hd, generator=gen, device=dev).to(dtype)
        if layout == "bskd":
            k, v = (torch.randn(B, S, KV, hd, generator=gen, device=dev
                                ).to(dtype).transpose(1, 2)
                    for _ in range(2))
        else:
            k, v = (torch.randn(B, KV, S, hd, generator=gen, device=dev
                                ).to(dtype) for _ in range(2))
        length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        ks, vs = (t[:, :, :kv_len].contiguous() for t in (k, v))
        esize = q.element_size()
        n_bytes = (2 * B * KV * kv_len * hd + 2 * B * KV * G_ * hd) * esize

        def body():
            return DA.decode_attention_bkgd(q, k, v, length)

        def lib():
            return sdpa(q, ks, vs)

        t = min(window(body) for _ in range(3))
        ts = min(window(lib) for _ in range(3))
        tp = window(lambda: DA.decode_attention_plain(q, k, v, kv_len), 5)
        (td, merge), (tsd, _) = device(body), device(lib)
        bound = n_bytes / HBM * 1e3
        print(f"{src}: {dt} (B, KV, G, S, hd) = ({B}, {KV}, {G_}, {S}, "
              f"{hd}) {layout} kv_len {kv_len}: body {t:.4f} ms "
              f"({n_bytes / t / 1e6:.0f} GB/s, {100 * bound / t:.1f}% of "
              f"the bound), device {td:.4f} ms ({100 * bound / td:.1f}%; "
              f"the merge {merge:.4f}), "
              f"call {call(body):.4f} ms; SDPA on the kv_len slice "
              f"{ts:.4f} ms ({n_bytes / ts / 1e6:.0f} GB/s), device "
              f"{tsd:.4f} ms; plain {tp:.4f} ms; bound {bound:.4f} ms "
              f"({n_bytes / 1e9:.4f} GB "
              f"at {HBM / 1e12:.2f} TB/s)", flush=True)
        del q, k, v, ks, vs
        torch.cuda.empty_cache()


def sass(a: str, b: str) -> int:
    """Compare the SASS of each kernel function of two trees' decode
    attention libraries; 1 if a function both have differs."""
    funcs = []
    for src in (a, b):
        sys.path.insert(0, os.path.abspath(src))
        for mod in [m for m in sys.modules if m.startswith("repro_torch")]:
            del sys.modules[mod]
        from repro_torch.kernels import build
        path = build.build_all(["decode_attention"])["decode_attention"]
        tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
        out = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True, check=True).stdout
        sys.path.pop(0)
        by_name = {}
        for f in out.split("Function : ")[1:]:
            head, body = f.split("\n", 1)
            hashed = (r"_GLOBAL__N__[0-9a-f]{8}_\d+_decode_attention_cu_"
                      r"[0-9a-f]{8}")
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
    ap.add_argument("--dtype", choices=("bfloat16", "float32", "both"),
                    default="both")
    ap.add_argument("--others", action="store_true",
                    help="also time the hd 64 and 128 bodies")
    ap.add_argument("--shapes", action="store_true",
                    help="time only the phase-24 shapes (WIDE)")
    ap.add_argument("--sass", action="store_true",
                    help="compare two trees' SASS, function by function")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("src", nargs="*", default=["src"])
    args = ap.parse_args(argv)
    if args.sass:
        if len(args.src) != 2:
            ap.error("--sass takes two trees")
        return sass(*args.src)
    dtypes = (("bfloat16", "float32") if args.dtype == "both"
              else (args.dtype,))
    if args.one:
        times(args.src[0], dtypes, args.others, args.shapes)
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
                             + (["--shapes"] if args.shapes else [])
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
