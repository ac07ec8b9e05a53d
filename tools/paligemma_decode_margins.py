"""paligemma-3b's greedy bf16 decode under the decode attention kernel and
under its plain version, with the logits where the tokens part.

    python3 tools/paligemma_decode_margins.py [SRC ...]     # on a CUDA card

Runs the smoke's paligemma-3b serving (``family_setup(..., "paligemma")``
in ``chip_smoke.py``: full width, bf16, ``attn_impl="pallas"``, random
weights from its seed, 8 requests x (256 patch embeddings + 64 tokens),
32 greedy decode steps) once for each source tree (a directory holding
``repro_torch``; ``src`` by default), in the order given and each in a
process of its own, then once more with the first tree and
``ops.decode_attention`` replaced by its plain version.  Each run keeps
its 33 steps' logits in float32 under ``build/margins/``.

Then, for each tree against the plain run and each later tree against
the first: the largest logit gap at the first decode step (where every
run has the same inputs) beside the largest logit and one bf16 step at
its size; and, for each request, the common prefix of the greedy tokens
and, at the first step where they part, both runs' top-2 tokens and
margins and the largest logit gap there.  A gap at least the margin it
faces explains the parting; a gap well above the first step's says the
kernel, not rounding, moved the logits.  Prints the card's name and
power limit first.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, ".."))
OUT = os.path.join(ROOT, "build", "margins")


def run(src: str, out: str, plain: bool) -> None:
    sys.path[:0] = [os.path.abspath(src), ROOT]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.models import serve as SV
    build.build_all(["decode_attention"])
    dev = torch.device("cuda")
    cfg, params, embeds, prompts, n_dec, cap, _ = cs.family_setup(
        torch, dev, False, "paligemma")
    if plain:
        def decode_plain(q, k, v, kv_len, **_):
            B, H, hd = q.shape
            KV = k.shape[2]
            return DA.decode_attention_plain(
                q.reshape(B, KV, H // KV, hd), k.transpose(1, 2),
                v.transpose(1, 2), kv_len).reshape(B, H, hd)
        ops.decode_attention = decode_plain
    kept = []

    def prefill(*args, **kw):
        logits, cache, extra = SV.prefill(*args, **kw)
        kept.append(logits.float().cpu())
        return logits, cache, extra

    def decode_step(*args, **kw):
        logits, cache = SV.decode_step(*args, **kw)
        kept.append(logits.float().cpu())
        return logits, cache

    ops.reset_launch_counts()
    cache = SV.init_cache(cfg, prompts.shape[0], cap, device=dev)
    _, _, toks, finite, _ = cs.serve_steps(
        torch, dev, types.SimpleNamespace(prefill=prefill,
                                          decode_step=decode_step),
        params, cfg, prompts, cache, n_dec, embeds=embeds)
    launches = ops.launch_counts()["decode_attention_bkgd"]
    cs.check(finite, f"{src}: a logit is not finite")
    cs.check(launches == (0 if plain else cfg.n_layers * n_dec),
             f"{src}: {launches} decode attention launches")
    torch.save({"tokens": toks.cpu(), "logits": torch.stack(kept)}, out)
    print(f"{src}{' (plain decode attention)' if plain else ''}: "
          f"{launches} kernel launches; first request's tokens "
          f"{toks[0].tolist()}", flush=True)


def bf16_step(x: float) -> float:
    """The gap between bf16 values at the size of x."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def compare(name_a: str, a: dict, name_b: str, b: dict) -> None:
    ta, tb, la, lb = a["tokens"], b["tokens"], a["logits"], b["logits"]
    top = float(lb[1].abs().max())
    print(f"{name_a} against {name_b}: step 1 (the same inputs) largest "
          f"logit gap {float((la[1] - lb[1]).abs().max()):.6g} (largest "
          f"logit {top:.6g}, one bf16 step there {bf16_step(top):.6g})",
          flush=True)
    for r in range(ta.shape[0]):
        same = (ta[r] == tb[r]).tolist() + [False]
        p = same.index(False)
        if p == ta.shape[1]:
            print(f"  request {r}: all {p} tokens equal", flush=True)
            continue
        va, ia = la[p, r].topk(2)
        vb, ib = lb[p, r].topk(2)
        gap = float((la[p, r] - lb[p, r]).abs().max())
        top = float(lb[p, r].abs().max())
        print(f"  request {r}: common prefix {p} of {ta.shape[1]}; at step "
              f"{p} {name_b}'s top 2 {ib.tolist()} margin "
              f"{float(vb[0] - vb[1]):.6g}, {name_a}'s {ia.tolist()} margin "
              f"{float(va[0] - va[1]):.6g}; largest logit gap {gap:.6g} "
              f"(one bf16 step at the largest logit {bf16_step(top):.6g})",
              flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        run(argv[1], argv[2], argv[3] == "plain")
        return 0
    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    srcs = argv or ["src"]
    runs = [(src, os.path.join(OUT, f"run{i}.pt"), "kernel")
            for i, src in enumerate(srcs)]
    runs.append((srcs[0], os.path.join(OUT, "plain.pt"), "plain"))
    for src, out, how in runs:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", src, out, how]).returncode
        if rc:
            return rc
    import torch
    got = [torch.load(out) for _, out, _ in runs]
    for i, src in enumerate(srcs):
        compare(src, got[i], "plain", got[-1])
    for i in range(1, len(srcs)):
        compare(srcs[i], got[i], srcs[0], got[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
