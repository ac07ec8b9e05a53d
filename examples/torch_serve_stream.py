"""Backbone serving demo on the PyTorch/CUDA port: batched requests with KV
caches — the twin of examples/serve_stream.py, importing only
``repro_torch``.

Serves a reduced qwen2-0.5b-family model: batched prefill, then a decode
loop on the stacked (L, B, S, KV, hd) cache, written in place.  Also
demonstrates live-stream ingestion with the straggler-drop policy.  The
model lives on ``--device`` (default ``cuda``; ``--device cpu`` runs
anywhere, in a few seconds).

    python examples/torch_serve_stream.py [--batch 8] [--steps 24] [--device cpu]
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.streaming import StragglerPolicy, StreamExecutor
from repro_torch.device import resolve_device
from repro_torch.models import model as M, serve as SV


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen2_0p5b")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    B = args.batch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    max_len = args.prompt_len + args.steps + 8
    cache = SV.init_cache(cfg, B, max_len, device=dev)

    t0 = time.perf_counter()
    logits, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {B}x{args.prompt_len} tokens in {t_prefill*1e3:.0f} ms "
          f"({B*args.prompt_len/t_prefill:.0f} tok/s) on {dev}")

    t0 = time.perf_counter()
    outs = [torch.argmax(logits, -1)[:, None]]
    for _ in range(args.steps):
        logits, cache = SV.decode_step(params, cfg, outs[-1], cache=cache)
        outs.append(torch.argmax(logits, -1)[:, None])
    sync()
    t_dec = time.perf_counter() - t0
    print(f"decode: {args.steps} steps x {B} streams in {t_dec*1e3:.0f} ms "
          f"({B*args.steps/t_dec:.0f} tok/s); cache len "
          f"{int(cache['len'])}")

    # live stream with straggler mitigation: each batch is one decode step
    # on the served cache (it writes the same next row each time)
    def process(idx):
        SV.decode_step(params, cfg, outs[-1], cache=cache)
        sync()

    ex = StreamExecutor(process, batch=B,
                        policy=StragglerPolicy(fps=240.0, slack=1.0))
    st = ex.run(20 * B)
    print(f"stream: {st.frames_processed} processed, "
          f"{st.frames_dropped} dropped (deadline policy), "
          f"{st.fps:.0f} fps")
    return st


if __name__ == "__main__":
    main()
