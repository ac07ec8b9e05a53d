#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse # the same phases, tiny, on the CPU

Phases (any failure exits non-zero and prints no result line):

1. The card's name and power limit (nvidia-smi); build the CUDA kernels
   of src/repro_torch/kernels/csrc with nvcc, one process per source.
2. Training: ``train_filter`` on the detrac-like scene at the paper's
   g = 56, the 4-layer d_model 128 filter trunk (naive attention, as the
   JAX package trains it) with the IC head, 96 Adam steps at batch 8;
   first and last loss (both finite), ms per step, the paper's
   count accuracy on held-out frames, and the phase's peak memory.
3. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the trained weights' inputs): the two
   spatial-stats kernels bit for bit (``torch.equal``) as the planner
   calls them: ``classes=`` with the two classes it reads, on the full
   (32, 56, 56, 3) grid, the row kernel on an unsorted list of 16 int64
   row ids on the card, with duplicates; each beside two "before"
   readings, the kernel on the grid sliced beforehand and the
   composition the planner ran before (gather the planes,
   ``.contiguous()``, then the kernel); then the kernel's device time
   with the host's pick of the cluster size and at each size 1..8, at
   those calls and on (32, 56, 56, 8) grids, each bit for bit.  The CAM
   head at 1e-4, flash
   attention at max abs err 1e-4 (float32), plus a sweep of shapes,
   types, masks, GQA and ragged lengths (1e-4 float32, 2e-2 bfloat16),
   and a stress sweep of the float32 kernel's 3xTF32 split (q and k
   scaled by 3 and 8, values over four decades; 1e-4 against float64,
   and against the plain version except at x8); an in-run check that
   the plain version with one TF32 pass (``allow_tf32``) at the main
   shape, q and k scaled by 3, misses 1e-4.  Each kernel and library
   call is timed three ways: its device time per call from
   torch.profiler (25 calls after a warm-up; the ``ms`` of the kernel
   line), the median CUDA-event interval around one call ("call ms",
   the Python wrapper included), and CUDA events around 50
   back-to-back calls; the plain version by its call interval.  Beside
   them its bound and a library yardstick where one PyTorch call
   computes the same function.
4. The main path at full width: the trained filter served through the
   kernels (``attn_impl="pallas"`` trunk, CAM head kernel), 256 frames in
   batches of 32 through MultiQueryStreamExecutor -> MultiQueryExecutor
   -> MultiQueryCascade(adaptive=True), queries registered and retired
   mid-stream; then the same batches with ground-truth filter outputs,
   where the count tier decides most rows and the compacted spatial
   stage runs the row kernel.  Launch counts are reset just before and
   read just after; every kernel must have run (flash attention once
   per trunk layer and batch), the staged masks must equal the
   exhaustive plan's bit for bit, the answers must equal the exact
   oracle semantics, the kernel head must match the plain head, and the
   serving peak memory must stay under 2 GiB (no S x S scores).
5. One batch through the naive and the pallas trunk on the same trained
   weights: both timed, their outputs equal within rtol 1e-4 / atol 1e-3.
6. The RWKV-6 serving path at full width: rwkv6-3b (32 layers, d_model
   2560, vocab 65536, bf16) with random weights from a seeded CUDA
   generator, ``attn_impl="pallas"``; four requests of 1024 prompt tokens
   through ``prefill``, then 32 greedy ``decode_step``s, after one
   untimed warm-up pass.  Counts are reset just before and read just
   after: ``rwkv6_scan_bhtk`` must have launched once per layer and call
   (32 x 33); the tokens must lie in the vocabulary and every logit be
   finite.  Prefill tokens/s, ms per decode step and peak memory.
   The profile lines give the WKV scan's share of the device time.
7. The WKV-scan kernel against its plain version at that path's prefill
   and decode shapes (layer 0's inputs, kept from the warm-up with their
   strides: the time-mix's (B, T, H, K) tensors, read in place), timed;
   the strided call must equal the contiguous one bit for bit; and a
   sweep (T 1/32/50/1024, K 16/64, fp32 and bf16, non-zero u and s0, two
   halves carried through sT); 5e-3, plus one bf16 step of the output.
8. Decode attention through its entry point ``ops.decode_attention`` at
   qwen2-0.5b's decode_32k shape (B 128, S 32768, 14 heads over 2 kv
   heads, hd 64, bf16, kv_len 30000) on the model's (B, S, KV, hd) cache,
   counts reset just before and read just after; the call is timed whole,
   and its added peak memory must be no more than its output and split
   scratch (the cache is read in place, never copied); a repeated call
   and the (B, KV, S, hd) layout must give the same bits.  The kernel
   against its plain version, timed beside it and two
   ``scaled_dot_product_attention`` yardsticks (a boolean kv_len mask over
   all S rows; the kv_len slice, which reads the kernel's bytes), there
   in bf16 and in float32 (the same values); a sweep (the Pallas test's
   cases, ragged S, G 7/16, hd 128, a 20000-key cache in both types).
   Tolerances: 1e-4 in
   float32; in bf16 the Pallas test's 2e-2 or four bf16 steps of the
   largest output, whichever is smaller (a long cache's outputs are
   ~0.04, and a fixed 2e-2 would pass a kernel that ignored kv_len).
9. Float32 at full width (12.3 GB of weights, the bf16 ones freed): two
   256-token prompts and 8 decode steps through the kernel path and the
   chunked plain path (``xla_flash``) on the same weights and tokens,
   logits within 2e-2; and the kernel path's decode against a full
   forward over prompt + generated tokens, within 2e-2.
10. A ``kernels`` JSON line (all six kernels), then the device line as
    the last line.
"""
import argparse
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor cores
N_FRAMES, BATCH, WINDOW = 256, 32, 128
SEED = 0
TRAIN_STEPS, TRAIN_BATCH, TRAIN_FRAMES, EVAL_FRAMES = 96, 8, 256, 64
SERVING_PEAK_LIMIT = 2 * 2**30   # bytes; one S x S score tensor is 4.7 GiB
RWKV_REQUESTS, RWKV_PROMPT, RWKV_DECODE = 4, 1024, 32
RWKV_FP32_PROMPT, RWKV_FP32_DECODE = 256, 8
DECODE_KV_LEN = 30000            # valid rows of the 32768-row decode cache
# (B, Sq, Sk, H, KV, hd, causal, sliding_window, dtype): the Pallas kernel
# test's shapes in both types and both maskings, sliding windows with
# GQA 4/2, and ragged lengths that no 64-row tile divides
FLASH_SWEEP = (
    [(B, Sq, Sk, H, KV, hd, causal, None, dt)
     for (B, Sq, Sk, H, KV, hd) in [(1, 128, 128, 4, 4, 32),
                                    (2, 256, 256, 8, 2, 64),
                                    (1, 512, 512, 4, 1, 128)]
     for dt in ("float32", "bfloat16") for causal in (True, False)]
    + [(1, 256, 256, 4, 2, 32, True, sw, "float32") for sw in (32, 128)]
    + [(2, 300, 300, 4, 2, 32, True, None, "float32"),
       (2, 300, 300, 4, 2, 32, False, None, "bfloat16"),
       (1, 300, 300, 4, 4, 64, True, 100, "float32"),
       (1, 77, 300, 4, 4, 128, False, None, "float32")])


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=25, warmup=3):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, expect=None, calls=25, tries=5):
    """Device time per call of ``fn`` from torch.profiler, over ``calls``
    calls after a warm-up.  The profiler may miss launches of a window
    (a few, or on the card at times all of them), so each kernel is read
    by its mean over its recorded launches, times its launches per call:
    its count over that of the call's own kernel (``expect``, a piece of
    its name; for a library call, its least launched kernel); a window
    with no launch of ``expect`` is profiled again, up to ``tries``
    windows in all.  Fails if none records one.  Returns the time and the
    number of windows it took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for window in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0
                and e.self_device_time_total > 0]
        n = [e.count for e in kern if expect is None or expect in e.key]
        if n:
            return sum(e.self_device_time_total / e.count
                       * round(e.count / min(n)) for e in kern) / 1e3, window
    raise SmokeError(f"torch.profiler recorded no device time for "
                     f"{expect or 'a library call'} in {tries} windows")


def b2b_ms(torch, fn, calls=50):
    """CUDA events around ``calls`` back-to-back calls, over ``calls``."""
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


def kernel_times(torch, fn, expect=None):
    """The three readings of one kernel or library call (see phase 3),
    and the profiler windows the first took."""
    ms, windows = device_ms(torch, fn, expect)
    return {"ms": ms, "call_ms": time_ms(torch, fn),
            "b2b_ms": b2b_ms(torch, fn), "profiler_windows": windows}


def library_entry(t):
    """``kernel_times`` of a library call, under the kernel line's keys."""
    return {"library_ms": t["ms"], "library_call_ms": t["call_ms"],
            "library_b2b_ms": t["b2b_ms"],
            "library_profiler_windows": t.get("profiler_windows")}


def ptxas_lines(libs):
    """Registers and spills of every kernel, from the ``-Xptxas -v`` report
    ``build.build_all`` keeps beside each library (``<lib>.log``)."""
    prop = re.compile(r"Function properties for (\S+)\s+\d+ bytes stack "
                      r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s+ptxas info\s*: Used (\d+) registers")
    lines = []
    for name, path in sorted(libs.items()):
        with open(path + ".log") as f:
            log = f.read()
        parts = []
        for mangled, st, ld, regs in prop.findall(log):
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            fn, rest = mangled, ""
            if m:
                fn = mangled[m.end():m.end() + int(m.group(1))]
                rest = mangled[m.end() + int(m.group(1)):]
            args = [{"f": "float", "13__nv_bfloat16": "bf16",
                     "6__half": "half"}[a]
                    for a in re.findall(r"^I(f|13__nv_bfloat16|6__half)",
                                        rest)]
            args += re.findall(r"Li(\d+)E", rest.split("Ev")[0])
            args += [{"0": "false", "1": "true"}[b]
                     for b in re.findall(r"Lb([01])E", rest.split("Ev")[0])]
            tag = f"{fn}<{', '.join(args)}>" if args else fn
            parts.append(f"{tag} {regs} regs, spill {st}/{ld} B")
        lines.append(f"nvcc -Xptxas -v, {name}.cu: " + "; ".join(parts))
    return lines


def bound_ms(n_bytes, n_ops, flops=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch, dev):
    """Peak device memory since the last ``reset_peak`` (None on the CPU)."""
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def gib(n_bytes):
    return "not measured (CPU)" if n_bytes is None \
        else f"{n_bytes / 2**30:.3f} GiB"


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def configure(rehearse):
    from repro_torch.data.synthetic import DETRAC_LIKE
    from repro_torch.models.config import BranchSpec
    from repro_torch.train.filter_train import default_trunk
    g = 17 if rehearse else 56          # 289 tokens reach the flash path
    scene = dataclasses.replace(DETRAC_LIKE, grid=g)
    if rehearse:
        trunk = default_trunk(d_model=32, n_layers=2, grid=g)
        spec = BranchSpec(kind="ic", grid=g, n_classes=3, head_dim=16,
                          layer=2)
    else:
        trunk = default_trunk(d_model=128, n_layers=4, grid=g)
        spec = BranchSpec(kind="ic", grid=g, n_classes=3, head_dim=256,
                          layer=4)
    return scene, trunk, spec


def queries(g):
    """The monitor's population: busy frames, any car, a car left of a
    bus (guarded by the car count), and a rare-class region query; after
    the first window a rare-class ordering query registers and the
    car/bus one retires (at detrac density a car is in nearly every
    frame, so only rare-class guards let the count tier decide rows)."""
    from repro_torch.core import query as Q
    g2 = g // 2
    initial = {
        "busy": Q.Count(Q.Op.GE, 3),
        "car": Q.ClassCount(0, Q.Op.GE, 1),
        "car-left-of-bus": Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                                  Q.Spatial(0, Q.Rel.LEFT, 1, radius=1))),
        "truck-top-left": Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                                 Q.Region(2, (0, 0, g2, g2), 1))),
    }
    late = ("truck-left-of-car",
            Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                   Q.Spatial(2, Q.Rel.LEFT, 0))))
    return initial, late, "car-left-of-bus"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def training_phase(torch, dev, scene, trunk, spec, rehearse):
    """``train_filter`` on the naive trunk, then the paper's count
    accuracy on held-out frames.  Returns the trained filter and the
    report lines."""
    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.train.filter_train import evaluate_filter, train_filter
    steps = 12 if rehearse else TRAIN_STEPS
    n_frames = 64 if rehearse else TRAIN_FRAMES
    t0 = time.perf_counter()
    collect(VideoStream(scene), n_frames)        # what train_filter collects
    collect_s = time.perf_counter() - t0
    reset_peak(torch, dev)
    t0 = time.perf_counter()
    tf = train_filter(scene, spec, trunk_cfg=trunk, steps=steps,
                      batch=TRAIN_BATCH, n_frames=n_frames, seed=SEED,
                      device=dev)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    peak = peak_bytes(torch, dev)
    losses = tf.losses
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"training losses are not {steps} finite numbers: {losses}")
    ev = evaluate_filter(tf, scene, n_frames=16 if rehearse else EVAL_FRAMES,
                         device=dev)
    check(all(math.isfinite(ev[f"cf_acc_{t}"]) for t in (0, 1)),
          "evaluate_filter gave no count accuracy")
    warm = max(steps // 6, 1)        # train_filter's count-only steps
    return tf, [
        f"training: {steps} Adam steps at batch {TRAIN_BATCH} on "
        f"{n_frames} frames (g = {scene.grid}, naive trunk), loss "
        f"{losses[0]:.6f} (first) -> {losses[warm]:.6f} (step {warm}, the "
        f"grid term joins) -> {losses[-1]:.6f} (last), "
        f"{(wall - collect_s) / steps * 1e3:.2f} ms/step (train_filter "
        f"{wall:.3f} s less {collect_s:.3f} s collecting frames), peak "
        f"device memory {gib(peak)}",
        f"held-out ({EVAL_FRAMES if not rehearse else 16} frames, dynamics "
        f"seed 99): cf_acc_0 {ev['cf_acc_0']:.4f}, cf_acc_1 "
        f"{ev['cf_acc_1']:.4f}, cf_acc_2 {ev['cf_acc_2']:.4f}"]


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def run_stream(torch, dev, data, scene, filter_fn_for, record):
    """One pass of the stream through the port's executors.  Returns the
    window results, the (name -> qid) map and the engines built."""
    from repro_torch.core import cascade as CS
    from repro_torch.core.streaming import (HoppingWindow,
                                            MultiQueryStreamExecutor,
                                            QueryRegistry)
    initial, late, retire = queries(scene.grid)
    registry = QueryRegistry()
    names = {name: registry.register(q) for name, q in initial.items()}
    engines = []
    plan_s = [0.0]

    def factory(queries, slot_stats, leaf_table, step_cache, device):
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats,
                                   leaf_table=leaf_table,
                                   step_cache=step_cache)
        staged_masks = mqc.masks

        def masks(out, presumed_decided=None):
            sync(torch, dev)
            t0 = time.perf_counter()
            m = staged_masks(out, presumed_decided)
            sync(torch, dev)
            plan_s[0] += time.perf_counter() - t0
            record.append((queries, out, m))
            return m

        mqc.masks = masks
        ex = CS.MultiQueryExecutor(
            mqc, filter_fn_for, lambda idx, sel: [data["objects"][idx[j]]
                                                  for j in sel],
            scene.n_classes, scene.grid, oracle_bucket=16, device=device)
        engines.append(ex)
        return lambda idx: ex.run_batch(idx).answers

    executor = MultiQueryStreamExecutor(
        registry, factory, HoppingWindow(size=WINDOW, advance=WINDOW),
        BATCH, device=dev)

    def on_window(res):
        if res.span[0] == 0:
            names[late[0]] = registry.register(late[1])
            registry.retire(names[retire])

    t0 = time.perf_counter()
    results = executor.run(N_FRAMES, on_window)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    return results, names, engines, wall, plan_s[0], executor.rebuilds


def exact_hits(data, scene, results, names):
    """Per window and query: frames whose exact answer is True."""
    from repro_torch.core import query as Q
    initial, late, _ = queries(scene.grid)
    by_qid = {qid: (initial.get(n) or late[1]) for n, qid in names.items()}
    out = []
    for r in results:
        lo, hi = r.span
        out.append({qid: sum(Q.eval_objects(by_qid[qid], data["objects"][f],
                                            scene.n_classes, scene.grid)
                             for f in range(lo, hi))
                    for qid in r.hits})
    return out


def main_path(torch, dev, scene, serve, data):
    """Both passes of the stream, the learned one through ``serve`` (the
    trained filter on the pallas trunk, CAM head kernel); returns what
    the checks and the report need.  Launch counts and the peak memory
    cover exactly these two passes."""
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.kernels import ops
    embeds = torch.as_tensor(data["embeds"], device=dev)
    gt_counts = torch.as_tensor(data["counts"].astype("float32"), device=dev)
    gt_grid = torch.as_tensor(data["occupancy"], device=dev).float()

    def learned(idx):
        return serve.apply(embeds[torch.as_tensor(idx, device=dev)],
                           use_kernel=True, device=dev)

    def ground_truth(idx):
        i = torch.as_tensor(idx, device=dev)
        return FilterOutputs(counts=gt_counts[i], grid=gt_grid[i])

    record = {"learned": [], "ground_truth": []}
    runs = {}
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    for name, fn in (("learned", learned), ("ground_truth", ground_truth)):
        runs[name] = run_stream(torch, dev, data, scene, fn, record[name])
    launches = ops.launch_counts()
    return runs, record, launches, peak_bytes(torch, dev)


def check_main_path(torch, data, scene, runs, record):
    from repro_torch.core.plan import QueryPlan
    lines = []
    for name, (results, names, engines, wall, plan_s, rebuilds) in \
            runs.items():
        expected = exact_hits(data, scene, results, names)
        for r, want in zip(results, expected):
            for qid, n in r.hits.items():
                if name == "ground_truth":
                    check(n == want[qid], f"{name}: window {r.span} query "
                          f"{qid}: {n} hits, exact answer {want[qid]}")
                else:
                    check(n <= want[qid], f"{name}: window {r.span} query "
                          f"{qid}: {n} hits exceed the exact {want[qid]}")
        check(rebuilds == 2, f"{name}: {rebuilds} engine rebuilds, want 2")
        bodies = [b for e in engines
                  for b in (e.cascade.staging_report.bodies
                            if e.cascade.staging_report else [])]
        oracle = sum(e.stats.oracle_calls for e in engines)
        filt = sum(e.stats.filter_time_s for e in engines) - plan_s
        orac = sum(e.stats.oracle_time_s for e in engines)
        lines.append(f"{name}: {N_FRAMES / wall:.1f} frames/s, wall "
                     f"{wall * 1e3:.1f} ms = filter {filt * 1e3:.1f} ms + "
                     f"plan {plan_s * 1e3:.1f} ms + oracle {orac * 1e3:.1f}"
                     f" ms + rest, oracle calls {oracle}, hits "
                     f"{[r.hits for r in results]}, last bodies {bodies}")
    n_masks = 0
    for name, recs in record.items():
        for qs, out, staged in recs:
            want = QueryPlan(qs).evaluate(out)
            check(torch.equal(staged, want),
                  f"{name}: staged masks differ from the exhaustive plan")
            n_masks += 1
    lines.append(f"staged == exhaustive on {n_masks} batches, bit for bit")
    return lines


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch, dev, trunk, spec, params, data):
    """The main path's kernel inputs for the first batch: the first trunk
    layer's q, k, v (B, H, S, hd), the CAM head's features, the
    ground-truth (B, g, g, 3) grid with the two classes the first
    window's spatial stage reads (the planner passes both to the stats
    kernel), and a padded 16-row list of int64 ids on the card."""
    from repro_torch.core import cam as CAM
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    e = torch.as_tensor(data["embeds"][:BATCH], device=dev)
    x = torch.einsum("bpd,de->bpe", e, params["proj"])
    x = x + params["pos"][: x.shape[1]][None]
    layer0 = {name: {k: t[0] for k, t in sub.items()}
              for name, sub in params["trunk"]["layers"].items()}
    h = L.apply_norm(layer0["ln1"], x, trunk.norm_eps)
    qkv = [torch.einsum("bsd,dhk->bhsk", h, layer0["attn"][w]).contiguous()
           for w in ("wq", "wk", "wv")]
    tap = M.forward(params["trunk"], trunk, embeds=x, tap_layer=spec.layer,
                    stop_at_tap=True, causal=False).tap
    feat = CAM.spatialize(tap.float(), spec.grid)
    feat = torch.relu(torch.einsum("bijd,de->bije", feat,
                                   params["branch"]["proj"]))
    B, g, _, D = feat.shape
    feat = feat.reshape(B, g * g, D).contiguous()
    full = torch.as_tensor(data["occupancy"][:BATCH], device=dev).float()
    classes = torch.tensor([0, 1], device=dev)
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.randint(0, BATCH, (16,), generator=gen)
    rows[-4:] = rows[-5]                         # bucket-style padding
    return qkv, feat, (full, classes), rows.to(dev)


def stats_entry(torch, SP, full, classes, rows):
    """Row 1 (``rows`` None) or 2 of the kernel line, at the planner's
    call: ``classes=`` on the full grid (and, for row 2, the plan's int64
    row ids on the card), bit for bit against its plain version, with its
    bytes bound counting every plane it reads.  Beside it, two "before"
    readings: the kernel on the grid sliced beforehand, and the
    composition the planner ran before (gather the planes,
    ``.contiguous()``, then the kernel), timed with the call in the order
    old, new, new, old and averaged."""
    sliced = full[..., classes].contiguous()
    B, g, _, C = full.shape
    Cp = classes.numel()
    if rows is None:
        def new():
            return SP.spatial_stats_bgc(full, classes=classes)

        def plain():
            return SP.spatial_stats_plain(full, classes=classes)

        def on_sliced():
            return SP.spatial_stats_bgc(sliced)

        def compose():
            return SP.spatial_stats_bgc(full[..., classes].contiguous())
        name, line, R, frames = "spatial_stats_bgc", 44, B, B
    else:
        def new():
            return SP.spatial_stats_rows_bgc(full, rows, classes=classes)

        def plain():
            return SP.spatial_stats_rows_plain(full, rows, classes=classes)

        def on_sliced():
            return SP.spatial_stats_rows_bgc(sliced, rows)

        def compose():
            return SP.spatial_stats_rows_bgc(
                full[..., classes].contiguous(), rows)
        name, line = "spatial_stats_rows_bgc", 66
        R, frames = rows.numel(), int(torch.unique(rows).numel())
    got, want = new(), plain()
    check(torch.equal(got, want), f"{name}(classes=) on the full grid "
          f"differs from plain")
    check(torch.equal(on_sliced(), want), f"{name} on the sliced grid "
          f"differs from plain")
    times = {"new": [], "compose": []}
    for which, fn in (("compose", compose), ("new", new), ("new", new),
                      ("compose", compose)):
        times[which].append(kernel_times(torch, fn, "spatial_stats_kernel"))
    before = kernel_times(torch, on_sliced, "spatial_stats_kernel")
    read = {"ms": "", "call_ms": "call_", "b2b_ms": "b2b_"}
    n_bytes = (frames * g * g * C * full.element_size() + Cp * 8
               + R * Cp * 5 * 4 + (R * 8 if rows is not None else 0))
    bnd, by = bound_ms(n_bytes, frames * g * g * Cp)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spatial_stats.cu",
        "replaces": f"src/repro/kernels/spatial_predicate.py:{line}",
        "max_abs_err": float((got - want).abs().max()),
        **{k: sum(t[k] for t in times["new"]) / 2 for k in read},
        "profiler_windows": times["new"][0]["profiler_windows"],
        "plain_ms": time_ms(torch, plain),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": [B, g, g, C] + ([R] if rows is not None else []),
        "classes": classes.tolist(),
        **({"rows_dtype": str(rows.dtype)} if rows is not None else {}),
        **{f"sliced_{p}ms": before[k] for k, p in read.items()},
        **{f"compose_{p}ms": sum(t[k] for t in times["compose"]) / 2
           for k, p in read.items()}}


def cluster_sweep(torch, SP, dev, full, classes, rows):
    """Device time of the stats kernel with the host's pick of the
    cluster size ("auto") and forced to each size 1..8, each result equal
    to the plain version bit for bit: at the planner's two calls on the
    C = 3 grid, and on (32, 56, 56, 8) grids, the frames of the model
    configurations' g = 56 branches with 8 classes, where the host
    splits a frame."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wide = (torch.rand((full.shape[0], 56, 56, 8), generator=gen,
                       device=dev) < 0.05).float()
    lines = []
    for name, x, r, c in (
            ("(32, 56, 56, 3) classes=[0, 1]", full, None, classes),
            ("16 rows of (32, 56, 56, 3) classes=[0, 1]", full, rows,
             classes),
            ("(32, 56, 56, 8)", wide, None, None),
            ("(32, 56, 56, 8) classes=[0, 1]", wide, None, classes),
            ("16 rows of (32, 56, 56, 8) classes=[0, 1]", wide, rows,
             classes),
            ("(32, 56, 56, 8) bfloat16", wide.bfloat16(), None, None)):
        want = SP.spatial_stats_plain(x, classes=c) if r is None \
            else SP.spatial_stats_rows_plain(x, r, classes=c)
        parts = []
        for S in range(9):
            def fn():
                return SP._launch(x, r, c, 0.2, cluster=S)
            check(torch.equal(fn(), want), f"spatial_stats at cluster size "
                  f"{S or 'auto'} on {name} differs from plain")
            ms, _ = device_ms(torch, fn, "spatial_stats_kernel")
            parts.append(f"{S or 'auto'}: {ms:.5f}")
        lines.append(f"spatial_stats cluster sweep {name}, device ms by "
                     f"cluster size: " + ", ".join(parts))
    return lines


def kernel_phase(torch, dev, feat, params, grids, rows):
    from repro_torch.kernels import cam_head as CH
    from repro_torch.kernels import spatial_predicate as SP
    w = params["branch"]["w"].contiguous()
    b = params["branch"]["b"].contiguous()
    full, classes = grids
    entries = [stats_entry(torch, SP, full, classes, None),
               stats_entry(torch, SP, full, classes, rows)]
    sweep = cluster_sweep(torch, SP, dev, full, classes, rows)

    c_k, m_k = CH.cam_head_bgd(feat, w, b)
    c_p, m_p = CH.cam_head_plain(feat, w, b)
    err = max(float((c_k - c_p).abs().max()), float((m_k - m_p).abs().max()))
    check(torch.allclose(m_k, m_p, rtol=1e-4, atol=1e-4)
          and torch.allclose(c_k, c_p, rtol=1e-4, atol=1e-4),
          f"cam_head_bgd differs from plain (max abs err {err})")
    c_2, m_2 = CH.cam_head_bgd(feat, w, b)
    check(torch.equal(c_2, c_k) and torch.equal(m_2, m_k),
          "cam_head_bgd gave other bits on a repeated call")
    Bf, P, D = feat.shape
    Cw = w.shape[1]
    bnd, by = bound_ms(Bf * P * D * 4 + D * Cw * 4 + Cw * 4 + Bf * Cw * 4
                       + Bf * P * Cw * 4, 2 * Bf * P * D * Cw)
    entries.append({
        "name": "cam_head_bgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_head.cu",
        "replaces": "src/repro/kernels/cam_head.py:49",
        "max_abs_err": err, "repeat_bit_identical": True,
        **kernel_times(torch, lambda: CH.cam_head_bgd(feat, w, b),
                       "cam_tile_kernel"),
        "plain_ms": time_ms(torch, lambda: CH.cam_head_plain(feat, w, b)),
        "bound_ms": bnd, "bound_by": by,
        **library_entry(kernel_times(torch, lambda: torch.matmul(feat, w))),
        "shape": [Bf, P, D, Cw]})
    return entries, sweep


def attention64(torch, q, k, v, causal):
    """The plain version's function in float64 (no window)."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(i >= j, s, torch.full((), -0.7 * 3.4028234663852886e38,
                                              dtype=s.dtype, device=s.device))
    return torch.softmax(s, -1) @ v


def flash_phase(torch, qkv):
    """Flash attention at the main path's shape against its plain
    version, timed; the in-run TF32 check; then the sweep of
    ``FLASH_SWEEP`` and the float32 stress sweep."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = qkv
    out = FA.flash_attention_bhsd(q, k, v, causal=False)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    err = float((out - want).abs().max())
    check(err <= 1e-4, f"flash_attention_bhsd differs from plain at the "
          f"main path's shape (max abs err {err}, tol 1e-4)")
    del out, want
    B, H, S, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    n_bytes = (2 * B * H * S + 2 * B * KV * Sk) * hd * 4
    flops = 4 * B * H * S * Sk * hd
    # the float32 kernel runs three TF32 tensor-core products per product
    bnd, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "max_abs_err": err,
        **kernel_times(torch, lambda: FA.flash_attention_bhsd(
            q, k, v, causal=False), "flash_attention_kernel"),
        "plain_ms": time_ms(torch, lambda: FA.flash_attention_plain(
            q, k, v, causal=False)),
        "bound_ms": bnd, "bound_by": by,
        "bound_note": f"3 x {flops / 1e9:.1f} GFLOP of TF32 at 495 TFLOP/s "
                      f"(3xTF32); in SIMT fp32 at 67 TFLOP/s "
                      f"{bound_ms(n_bytes, flops)[0]:.4f} ms",
        **library_entry(kernel_times(torch, lambda: sdpa(q, k, v))),
        "shape": [B, S, H, hd]}
    lines = [tf32_check(torch, FA, q.shape)]

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, Sq, Sk, H, KV, hd, causal, sw, dt) in enumerate(FLASH_SWEEP):
        gen = torch.Generator(device=q.device).manual_seed(i)
        dtype = getattr(torch, dt)
        a, b, c = (torch.randn(shape, generator=gen, device=q.device
                               ).to(dtype)
                   for shape in ((B, H, Sq, hd), (B, KV, Sk, hd),
                                 (B, KV, Sk, hd)))
        o = FA.flash_attention_bhsd(a, b, c, causal=causal,
                                    sliding_window=sw)
        w = FA.flash_attention_plain(a, b, c, causal=causal,
                                     sliding_window=sw)
        e = float((o.float() - w.float()).abs().max())
        tol = 1e-4 if dt == "float32" else 2e-2
        check(o.dtype == dtype and e <= tol,
              f"flash sweep {(B, Sq, Sk, H, KV, hd, causal, sw, dt)}: max "
              f"abs err {e} (tol {tol}), dtype {o.dtype}")
        worst[dt] = max(worst[dt], e)
    lines.append(f"flash sweep: {len(FLASH_SWEEP)} cases (hd 32/64/128, "
                 f"causal and not, windows 32/128/100, GQA, ragged S 300 "
                 f"and Sq 77 x Sk 300) within tolerance: max abs err "
                 f"{worst['float32']:.3g} float32 (tol 1e-4), "
                 f"{worst['bfloat16']:.3g} bfloat16 (tol 2e-2)")
    lines.append(flash_stress(torch, FA, q.device))
    return entry, lines


def tf32_check(torch, FA, shape):
    """The 1e-4 the float32 kernel is held to must catch a kernel with one
    TF32 pass: the plain version with ``allow_tf32`` on, at the main
    shape with q and k scaled by 3 (seeded normal inputs), must miss the
    float32 plain version by more than 1e-4; the kernel must not."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    q, k = q * 3, k * 3
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = FA.flash_attention_plain(q, k, v, causal=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    e_one = float((one - want).abs().max())
    del one
    e_kernel = float((FA.flash_attention_bhsd(q, k, v, causal=False)
                      - want).abs().max())
    check(e_one > 1e-4, f"a one-pass TF32 plain version is within 1e-4 "
          f"({e_one}): the float32 tolerance would not catch TF32")
    check(e_kernel <= 1e-4, f"flash_attention_bhsd at the main shape with "
          f"q, k x3: max abs err {e_kernel} (tol 1e-4)")
    return (f"TF32 check at {list(shape)}, q and k x3: the plain version "
            f"with one TF32 pass misses float32 by {e_one:.3g} (> 1e-4), "
            f"the 3xTF32 kernel by {e_kernel:.3g} (tol 1e-4)")


# (hd, causal, kind) of tests/test_torch_cuda.py's FLASH_STRESS
FLASH_STRESS = [(hd, causal, kind) for hd in (32, 128)
                for causal in (False, True)
                for kind in ("qk x3", "qk x8", "v spread")]


def flash_stress(torch, FA, dev):
    """The float32 kernel on inputs that stress its 3xTF32 split, at
    (B, H, KV, S) = (1, 4, 2, 1000): max abs err 1e-4 against float64;
    against the plain version too, except at x8, where the plain
    version's own error against float64 is reported beside it."""
    worst = {"k64": 0.0, "kplain": 0.0, "plain64_x8": 0.0, "k64_x8": 0.0}
    for hd, causal, kind in FLASH_STRESS:
        rng = np.random.default_rng(hd + causal)    # the card test's inputs
        q, k, v = (torch.as_tensor(rng.normal(0, 1, (1, n, 1000, hd)).astype(
            np.float32), device=dev) for n in (4, 2, 2))
        if kind.startswith("qk"):
            f = float(kind[-1])
            q, k = q * f, k * f
        else:
            v = v * torch.as_tensor(10.0 ** np.random.default_rng(7).uniform(
                -3, 1, v.shape).astype(np.float32), device=dev)
        out = FA.flash_attention_bhsd(q, k, v, causal=causal)
        w64 = attention64(torch, q, k, v, causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        e64 = float((out.double() - w64).abs().max())
        ep = float((out - want).abs().max())
        check(e64 <= 1e-4 and (kind == "qk x8" or ep <= 1e-4),
              f"flash stress {(hd, causal, kind)}: max abs err {e64} "
              f"against float64, {ep} against plain (tol 1e-4)")
        if kind == "qk x8":
            worst["k64_x8"] = max(worst["k64_x8"], e64)
            worst["plain64_x8"] = max(
                worst["plain64_x8"],
                float((want.double() - w64).abs().max()))
        else:
            worst["k64"] = max(worst["k64"], e64)
            worst["kplain"] = max(worst["kplain"], ep)
    return (f"flash float32 stress: {len(FLASH_STRESS)} cases (hd 32/128, "
            f"causal and not, q and k x3 / x8, v over 1e-3..10): max abs "
            f"err {worst['k64']:.3g} against float64 and "
            f"{worst['kplain']:.3g} against plain at x3 and v spread; at "
            f"x8 {worst['k64_x8']:.3g} against float64, where the float32 "
            f"plain version itself is {worst['plain64_x8']:.3g} off "
            f"(tol 1e-4)")


def trunk_compare(torch, dev, tf, serve, data):
    """One batch through the naive trunk and the pallas trunk on the same
    trained weights: host-clock time around synchronised work (median of
    3 after a warm-up), peak memory, and agreement."""
    e = torch.as_tensor(data["embeds"][:BATCH], device=dev)
    outs, lines = {}, []
    for name, f in (("naive", tf), ("pallas", serve)):
        reset_peak(torch, dev)
        outs[name] = f.apply(e, use_kernel=True, device=dev)
        sync(torch, dev)
        peak = peak_bytes(torch, dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            f.apply(e, use_kernel=True, device=dev)
            sync(torch, dev)
            times.append(time.perf_counter() - t0)
        lines.append(f"filter forward of one batch ({BATCH} frames) "
                     f"through the {name} trunk: "
                     f"{sorted(times)[1] * 1e3:.3f} ms, peak device memory "
                     f"{gib(peak)}")
    a, b = outs["naive"], outs["pallas"]
    err = max(float((a.counts - b.counts).abs().max()),
              float((a.grid - b.grid).abs().max()))
    check(torch.allclose(b.counts, a.counts, rtol=1e-4, atol=1e-3)
          and torch.allclose(b.grid, a.grid, rtol=1e-4, atol=1e-3),
          f"pallas trunk differs from naive trunk (max abs err {err})")
    lines.append(f"pallas trunk vs naive trunk FilterOutputs: max abs err "
                 f"{err:.3g} (tol rtol 1e-4, atol 1e-3)")
    return lines


def plain_head_check(torch, dev, trunk, spec, params, data):
    """The kernel filter path against the plain-head filter path."""
    from repro_torch.train.filter_train import filter_forward
    e = data["embeds"][:BATCH]
    k = filter_forward(params, trunk, spec, e, use_kernel=True, device=dev)
    p = filter_forward(params, trunk, spec, e, use_kernel=False, device=dev)
    err = max(float((k.counts - p.counts).abs().max()),
              float((k.grid - p.grid).abs().max()))
    check(torch.allclose(k.counts, p.counts, rtol=1e-4, atol=1e-4)
          and torch.allclose(k.grid, p.grid, rtol=1e-4, atol=1e-4),
          f"kernel head differs from plain head (max abs err {err})")
    check(bool(torch.isfinite(k.grid).all()) and k.grid.shape ==
          (BATCH, spec.grid, spec.grid, spec.n_classes),
          "filter outputs are not finite or have the wrong shape")
    return f"kernel head vs plain head: max abs err {err:.3g} (tol 1e-4)"



# ---------------------------------------------------------------------------
# the RWKV-6 serving path (prefill + decode) and its WKV-scan kernel
# ---------------------------------------------------------------------------

def rwkv_config(rehearse, **overrides):
    """rwkv6-3b at its published widths (32 layers, d_model 2560, 40 heads
    of 64, d_ff 8960, vocab 65536, bf16); the smoke config on the CPU."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config("rwkv6_3b") if rehearse else \
        get_config("rwkv6_3b")
    return dataclasses.replace(cfg, **overrides)


class ScanRecorder:
    """Wraps ``ops.rwkv6_scan`` to keep, on the host, the arguments of its
    first call of each length class (prefill, decode); calls through
    unchanged."""

    def __init__(self, ops):
        self.ops, self.inner, self.calls = ops, ops.rwkv6_scan, {}

    def __enter__(self):
        def rec(*args, **kw):
            key = "decode" if args[0].shape[2] == 1 else "prefill"
            if key not in self.calls:
                self.calls[key] = tuple(a.cpu() for a in args)
            return self.inner(*args, **kw)
        self.ops.rwkv6_scan = rec
        return self

    def __exit__(self, *exc):
        self.ops.rwkv6_scan = self.inner


def rwkv_serving_phase(torch, dev, rehearse):
    """Four requests through ``prefill`` and ``decode_step`` at full width
    in bf16 through the kernel path (``attn_impl="pallas"``).  Layer 0's
    scan inputs of the first prefill and decode calls are kept from the
    untimed warm-up pass (the same prompts and weights) for the kernel
    phase; counts are reset just before the timed run and read just
    after."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = rwkv_config(rehearse, attn_impl="pallas", dtype="bfloat16")
    n_req, prompt_len, n_dec = (4, 64, 4) if rehearse else \
        (RWKV_REQUESTS, RWKV_PROMPT, RWKV_DECODE)
    gen = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, device=dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (n_req, prompt_len)), device=dev)

    def serve(record=None):
        cache = SV.init_cache(cfg, n_req, prompt_len + n_dec, device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
        sync(torch, dev)
        t_pre = time.perf_counter() - t0
        toks, finite, steps = [logits.argmax(-1)], \
            bool(torch.isfinite(logits).all()), []
        for _ in range(n_dec):
            t0 = time.perf_counter()
            logits, cache = SV.decode_step(params, cfg, toks[-1][:, None],
                                           cache=cache)
            toks.append(logits.argmax(-1))
            sync(torch, dev)
            steps.append(time.perf_counter() - t0)
            finite &= bool(torch.isfinite(logits).all())
        return t_pre, steps, torch.stack(toks, 1), finite

    with ScanRecorder(ops) as rec:            # warm-up: cuBLAS, the kernel
        serve()
    lines = []
    if dev.type == "cuda":
        cache = SV.init_cache(cfg, n_req, prompt_len + 1, device=dev)
        _, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
        lines.append(profile_line(
            torch, "one decode step", lambda: SV.decode_step(
                params, cfg, prompts[:, -1:], cache=cache),
            share_of="rwkv6_scan_kernel"))
        del cache
        lines.append(profile_line(
            torch, "one prefill", lambda: SV.prefill(
                params, cfg, prompts, cache=SV.init_cache(
                    cfg, n_req, prompt_len, device=dev)),
            share_of="rwkv6_scan_kernel"))
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    t_pre, steps, toks, finite = serve()
    launches = ops.launch_counts()
    peak = peak_bytes(torch, dev)
    check(finite, "rwkv serving: a logit is not finite")
    check(toks.shape == (n_req, n_dec + 1) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"rwkv serving: generated tokens {toks.shape} outside the vocab")
    want = cfg.n_layers * (1 + n_dec)
    if not rehearse:
        check(launches["rwkv6_scan_bhtk"] == want,
              f"rwkv6_scan_bhtk launched {launches['rwkv6_scan_bhtk']} "
              f"times, want {want} (one per layer and call)")
    steps_ms = sorted(x * 1e3 for x in steps)
    del params
    return launches, rec.calls, lines + [
        f"rwkv serving ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, random weights "
        f"drawn in {init_s:.3f} s): {n_req} requests x {prompt_len} "
        f"prompt tokens, prefill {t_pre * 1e3:.3f} ms = "
        f"{n_req * prompt_len / t_pre:.1f} tokens/s; {n_dec} decode steps "
        f"of {n_req} tokens, median {steps_ms[len(steps_ms) // 2]:.3f} ms "
        f"per step (min {steps_ms[0]:.3f}, max {steps_ms[-1]:.3f}); peak "
        f"device memory {gib(peak)}; rwkv6_scan_bhtk launches "
        f"{launches['rwkv6_scan_bhtk']} (want {want}); tokens in the "
        f"vocab, logits finite; first request's tokens "
        f"{toks[0].tolist()}"]


def profile_line(torch, what, fn, share_of=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler) and
    the host clock around it; the idle share is 1 - busy / wall (the
    profiler's own host cost counts in the wall).  ``share_of`` names a
    kernel (a piece of its name) whose share of the busy time is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        return f"profile of {what}: no device time recorded (not measured)"
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    share = ""
    if share_of is not None:
        mine = [e for e in kern if share_of in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        share = (f"{share_of} {ms:.3f} ms over "
                 f"{sum(e.count for e in mine)} launches = "
                 f"{ms / busy:.3f} of device busy; ")
    return (f"profile of {what} (torch.profiler): wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
            f"{sum(e.count for e in kern)} kernel launches; {share}top: " +
            "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top))


def scan_bound(args):
    """Least time of one WKV scan: bytes (each input read once, each
    output written once) or the recurrence's fp32 operations (per token
    and head: r S and the rank-1 update with its decay, 5 K V, the bonus
    3 K + 2 V)."""
    r, k, v, lw, u, s0 = args
    B, H, T, K = r.shape
    V = v.shape[3]
    elt = r.element_size()
    n_bytes = ((2 * K + V) * elt + K * 4) * B * H * T + u.numel() * 4 \
        + 2 * B * H * K * V * 4 + B * H * T * V * elt
    return bound_ms(n_bytes, B * H * T * (5 * K * V + 3 * K + 2 * V))


def scan_inputs(torch, dev, B, H, T, K, dt, seed):
    """The JAX kernel test's distributions, with a non-zero u and s0."""
    gen = torch.Generator(dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dtype = getattr(torch, dt)
    lw = torch.clamp(-torch.exp(n(B, H, T, K) * 0.3), -2.0, -1e-6)
    return (n(B, H, T, K).to(dtype), n(B, H, T, K).to(dtype),
            n(B, H, T, K).to(dtype), lw, n(H, K) * 0.1, n(B, H, K, K) * 0.1)


SCAN_TOL = ("out and sT atol 5e-3 (the JAX kernel test's); a bf16 out "
            "also rtol 1e-2: both sides round to bf16, one step apart at "
            "most")


def scan_err(torch, got, want):
    """Max abs error of (out, sT), and whether it is within SCAN_TOL."""
    (o, s), (wo, ws) = got, want
    err = max(float((o.float() - wo.float()).abs().max()),
              float((s - ws).abs().max()))
    rtol = 0.0 if o.dtype == torch.float32 else 1e-2
    ok = torch.allclose(o.float(), wo.float(), rtol=rtol, atol=5e-3) and \
        torch.allclose(s, ws, rtol=0, atol=5e-3)
    return err, ok


def rwkv_kernel_phase(torch, dev, calls, timer, ktimer):
    """The WKV kernel against its plain version at the serving path's
    prefill and decode shapes (layer 0's inputs), timed; then a sweep."""
    from repro_torch.kernels import rwkv6_scan as RK
    # the recorded inputs keep their strides: r, k, v, lw are the time-mix's
    # (B, T, H, K) tensors seen as (B, H, T, K), read in place
    args, dec = (tuple(t.to(dev) for t in calls[key])
                 for key in ("prefill", "decode"))
    err, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*args),
                       RK.rwkv6_scan_plain(*args))
    check(ok, f"rwkv6_scan_bhtk differs from plain at the prefill shape "
          f"(max abs err {err})")
    check(not args[0].is_contiguous() or dev.type == "cpu",
          "rwkv scan: the recorded prefill inputs are not the time-mix's "
          "strided views")
    dense = tuple(t.contiguous() for t in args)
    same = all(torch.equal(x, y) for x, y in zip(RK.rwkv6_scan_bhtk(*args),
                                                  RK.rwkv6_scan_bhtk(*dense)))
    check(same, "rwkv6_scan_bhtk on the strided views differs from the "
          "same inputs made contiguous")
    del dense
    o, sT = RK.rwkv6_scan_bhtk(*args)
    wo, ws = RK.rwkv6_scan_plain(*args)
    state_err = float((sT - ws).abs().max())
    rel = float(((o.float() - wo.float()).abs()
                 / wo.float().abs().clamp_min(1.0)).max())
    del o, sT, wo, ws
    bnd, by = scan_bound(args)
    B, H, T, K = args[0].shape
    entry = {
        "name": "rwkv6_scan_bhtk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:66",
        "max_abs_err": err, "max_abs_err_state": state_err,
        "max_rel_err_out": rel, "tolerance": SCAN_TOL,
        **ktimer(lambda: RK.rwkv6_scan_bhtk(*args), "rwkv6_scan_kernel"),
        "plain_ms": timer(lambda: RK.rwkv6_scan_plain(*args)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes the recurrence",
        "shape": [B, H, T, K], "dtype": str(args[0].dtype)}
    d_err, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*dec),
                         RK.rwkv6_scan_plain(*dec))
    check(ok, f"rwkv6_scan_bhtk differs from plain at the decode shape "
          f"(max abs err {d_err})")
    d_bnd, d_by = scan_bound(dec)
    d_t = ktimer(lambda: RK.rwkv6_scan_bhtk(*dec), "rwkv6_scan_kernel")
    lines = ["rwkv6_scan_bhtk on the time-mix's strided views equals the "
             "contiguous call bit for bit",
             f"rwkv6_scan_bhtk at the decode shape {list(dec[0].shape)}: "
             f"device {d_t['ms']} ms (call {d_t['call_ms']} ms, "
             f"back-to-back {d_t['b2b_ms']} ms; plain "
             f"{timer(lambda: RK.rwkv6_scan_plain(*dec))} ms, bound "
             f"{d_bnd:.6f} ms by {d_by}), max abs err {d_err:.3g}"]

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (T, K, dt) in enumerate((T, K, dt) for T in (1, 32, 50, 1024)
                                   for K in (16, 64)
                                   for dt in ("float32", "bfloat16")):
        a = scan_inputs(torch, dev, 2, 3, T, K, dt, i)
        e, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*a),
                         RK.rwkv6_scan_plain(*a))
        check(ok, f"rwkv scan sweep (T {T}, K {K}, {dt}): max abs err {e}")
        worst[dt] = max(worst[dt], e)
        if T == 50:                   # two halves carried through sT
            o1, s1 = RK.rwkv6_scan_bhtk(*(t[:, :, :21].contiguous()
                                          for t in a[:4]), a[4], a[5])
            o2, s2 = RK.rwkv6_scan_bhtk(*(t[:, :, 21:].contiguous()
                                          for t in a[:4]), a[4], s1)
            o, s = RK.rwkv6_scan_bhtk(*a)
            check(torch.equal(torch.cat([o1, o2], 2), o)
                  and torch.allclose(s2, s, rtol=0, atol=1e-5),
                  f"rwkv scan: halves carried through sT differ from the "
                  f"whole sequence (T {T}, K {K}, {dt})")
    lines.append(f"rwkv scan sweep: 16 cases (T 1/32/50/1024, K 16/64, "
                 f"float32/bfloat16, non-zero u and s0; T = 50 also as "
                 f"halves 21 + 29 carried through sT, equal to the whole) "
                 f"within tolerance: max abs err {worst['float32']:.3g} "
                 f"float32, {worst['bfloat16']:.3g} bfloat16 (tol 5e-3, "
                 f"bf16 out also rtol 1e-2)")
    return entry, lines


# ---------------------------------------------------------------------------
# decode attention, through its own entry point
# ---------------------------------------------------------------------------

def decode_phase(torch, dev, timer, ktimer, rehearse):
    """``ops.decode_attention`` (the JAX wrapper's layout) once at
    qwen2-0.5b's decode_32k shape, counts reset just before and read just
    after; then the kernel against its plain version and the library call
    at that shape, and the sweep."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops
    from repro_torch.models.config import shape_cell
    cfg = get_config("qwen2_0p5b")
    cell = shape_cell("decode_32k")
    B, S, H, KV, hd = (cell.global_batch, cell.seq_len, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    G, kv_len = H // KV, DECODE_KV_LEN
    if rehearse:
        B, S, kv_len = 2, 640, 600
    gen = torch.Generator(dev).manual_seed(SEED)
    q = torch.randn((B, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, length)
    sync(torch, dev)
    launches = ops.launch_counts()
    check(rehearse or launches["decode_attention_bkgd"] == 1,
          f"ops.decode_attention launched {launches} kernels")
    qg = q.reshape(B, KV, G, hd)
    kv_, vv_ = k.transpose(1, 2), v.transpose(1, 2)   # views, as ops passes
    # the entry point reads the cache in place: the call adds only its
    # output and the split scratch to the peak, and is timed whole
    reset_peak(torch, dev)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    again = ops.decode_attention(q, k, v, length)
    sync(torch, dev)
    call_peak = (torch.cuda.max_memory_allocated() - base
                 if dev.type == "cuda" else None)
    check(torch.equal(again, out), "ops.decode_attention is not "
          "bit-identical on a repeated call")
    del again
    plan = "split plan not measured (CPU)"
    if dev.type == "cuda":
        n_sm, per_sm = DA._slots(out.device, hd, 1, G,
                                 DA.build.library("decode_attention"))
        nsplit = DA.split_count(B, KV, S, n_sm, per_sm)
        plan = (f"{nsplit} splits per (b, kv head), {n_sm} SMs x {per_sm} "
                f"resident blocks (occupancy calculator)")
        scratch = (B * KV * G * hd * 2
                   + (B * KV * nsplit * G * (hd + 2) * 4 if nsplit > 1 else 0))
        check(call_peak <= scratch + 4096, f"ops.decode_attention added "
              f"{call_peak} bytes to the peak; its output and split scratch "
              f"are {scratch}: the cache was copied")
    entry_call = ktimer(lambda: ops.decode_attention(q, k, v, length),
                        "decode_attention_mma")
    kt, vt = (t.contiguous() for t in (kv_, vv_))
    check(torch.equal(DA.decode_attention_bkgd(qg, kt, vt, length),
                      out.reshape(B, KV, G, hd)),
          "decode_attention_bkgd on the (B, KV, S, hd) layout differs from "
          "the same cache read in place")
    want = DA.decode_attention_plain(qg, kt, vt, kv_len)
    err = float((out.reshape(B, KV, G, hd).float() - want.float()).abs()
                .max())
    tol = decode_tol(torch, want)
    check(err <= tol, f"decode_attention_bkgd differs from plain at "
          f"decode_32k (max abs err {err}, tol {tol})")
    # the checks must tell a wrong kv_len from the right one: all S rows
    # in bf16, kv_len rounded up to a 64-key tile in float32
    no_len = float((DA.decode_attention_plain(qg, kt, vt, S).float()
                    - want.float()).abs().max())
    del out, want
    q32, k32, v32 = qg.float(), kt.float(), vt.float()
    want32 = DA.decode_attention_plain(q32, k32, v32, kv_len)
    err32 = float((DA.decode_attention_bkgd(q32, k32, v32, length)
                   - want32).abs().max())
    tiled = float((DA.decode_attention_plain(q32, k32, v32,
                                             -(-kv_len // 64) * 64)
                   - want32).abs().max())
    del q32, k32, v32, want32
    check(err32 <= 1e-4, f"decode_attention_bkgd differs from plain at "
          f"decode_32k in float32 (max abs err {err32}, tol 1e-4)")
    check(no_len > tol and tiled > 1e-4,
          f"decode_32k checks too loose: ignoring kv_len moves the output "
          f"by {no_len} (bf16 tol {tol}), a tile-rounded kv_len by "
          f"{tiled} (float32 tol 1e-4)")
    mask = (torch.arange(S, device=dev) < kv_len)[None]      # (1, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 2 * B * KV * kv_len * hd * 2 + 2 * B * H * hd * 2
    bnd, by = bound_ms(n_bytes, 4 * B * H * kv_len * hd)
    sliced = ktimer(lambda: sdpa(qg, kt[:, :, :kv_len], vt[:, :, :kv_len]))
    contiguous = ktimer(lambda: DA.decode_attention_bkgd(qg, kt, vt, length),
                        "decode_attention_mma")
    entry = {
        "name": "decode_attention_bkgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:62",
        "max_abs_err": err, "max_abs_err_float32": err32,
        "launches": launches["decode_attention_bkgd"],
        "tolerance": f"{tol:.3g} in bf16 (four bf16 steps of the largest "
                     f"output), 1e-4 in float32 on the same values",
        # the kernel on the model's cache, read in place (the path)
        **ktimer(lambda: DA.decode_attention_bkgd(qg, kv_, vv_, length),
                 "decode_attention_mma"),
        "contiguous_ms": contiguous["ms"],
        "entry_point_ms": entry_call["ms"],
        "entry_point_call_ms": entry_call["call_ms"],
        "entry_point_added_peak_bytes": call_peak,
        "plain_ms": timer(lambda: DA.decode_attention_plain(qg, kt, vt,
                                                            kv_len)),
        "bound_ms": bnd, "bound_by": by,
        **library_entry(ktimer(lambda: sdpa(qg, kt, vt, attn_mask=mask))),
        "library_note": "SDPA with a boolean kv_len mask over all S rows",
        "library_sliced_ms": sliced["ms"],
        "library_sliced_call_ms": sliced["call_ms"],
        "shape": [B, KV, G, S, hd], "kv_len": kv_len,
        "dtype": "torch.bfloat16"}
    del qg, kt, vt, kv_, vv_, k, v

    worst, worst_share = {"float32": 0.0, "bfloat16": 0.0}, 0.0
    sweep = ([(2, 2, 4, S, klen, 64, dt)
              for S, klen in [(256, 256), (256, 100), (512, 1), (300, 300),
                              (300, 77)]
              for dt in ("float32", "bfloat16")]
             + [(3, 2, 7, 1000, 999, 64, "bfloat16"),
                (1, 1, 16, 640, 333, 128, "float32")]
             + [(1, 1, 7, 20000, 12345, 64, dt)
                for dt in ("float32", "bfloat16")])
    for i, (B, KV, G, S, klen, hd, dt) in enumerate(sweep):
        g = torch.Generator(dev).manual_seed(i)
        dtype = getattr(torch, dt)
        a, b, c = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, KV, G, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
        o = DA.decode_attention_bkgd(a, b, c, klen)
        w = DA.decode_attention_plain(a, b, c, klen)
        e = float((o.float() - w.float()).abs().max())
        case_tol = decode_tol(torch, w)
        check(o.dtype == dtype and e <= case_tol,
              f"decode sweep {(B, KV, G, S, klen, hd, dt)}: max abs err {e}"
              f" (tol {case_tol})")
        worst[dt] = max(worst[dt], e)
        if dt == "bfloat16":
            worst_share = max(worst_share, e / case_tol)
    return entry, [
        f"decode_attention_bkgd at decode_32k, bf16, on the model's (B, S, "
        f"KV, hd) cache read in place: device {entry['ms']} ms; on a "
        f"(B, KV, S, hd) copy {entry['contiguous_ms']} ms; "
        f"ops.decode_attention device {entry['entry_point_ms']} ms, call "
        f"{entry['entry_point_call_ms']} ms, added peak memory "
        f"{call_peak} bytes (output and split scratch only, no copy of the "
        f"cache); SDPA masked over all S device {entry['library_ms']} ms, "
        f"SDPA on the kv_len slice device {entry['library_sliced_ms']} ms "
        f"(call {entry['library_sliced_call_ms']} ms); bit-identical on a "
        f"repeated call and across the two layouts; {plan}",
        f"decode_attention_bkgd at decode_32k in float32 (the same "
        f"values): max abs err {err32:.3g} (tol 1e-4); the plain version "
        f"with kv_len ignored is {no_len:.3g} off in bf16 (tol {tol:.3g}), "
        f"with kv_len rounded up to 64 keys {tiled:.3g} in float32",
        f"decode sweep: {len(sweep)} cases ((S, kv_len) of the Pallas "
        f"test, ragged S 300, G 7/16, hd 128, a 20000-key cache in many "
        f"splits, in both types) within tolerance: max abs err "
        f"{worst['float32']:.3g} float32 (tol 1e-4), "
        f"{worst['bfloat16']:.3g} bfloat16 (tol: four "
        f"bf16 steps of the case's largest output, at most 2e-2; the worst "
        f"case used {worst_share:.3f} of its tol)"]


def decode_tol(torch, want):
    """1e-4 in float32.  In bf16 the Pallas test's 2e-2, or four bf16
    steps (2^(e - 7) for the largest |want| in [2^e, 2^(e+1))) where that
    is smaller: an output averages ~kv_len / e values of v, so a long
    cache's outputs are far below 1 and 2e-2 would pass a kernel that
    ignored kv_len (``decode_phase`` measures by how much)."""
    if want.dtype == torch.float32:
        return 1e-4
    m = float(want.float().abs().max())
    return min(2e-2, 4 * 2.0 ** (math.floor(math.log2(m)) - 7))


def kernel_line(e):
    extra = "".join(f", {k} {e[k]:.3g}" for k in ("max_abs_err_state",
                                                   "max_rel_err_out")
                    if k in e)
    return (f"kernel {e['name']} {e['shape']} {e['dtype']}: device "
            f"{e['ms']} ms (call {e['call_ms']} ms, back-to-back "
            f"{e['b2b_ms']} ms; plain {e['plain_ms']} ms, bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']}, library device "
            f"{e['library_ms']} ms, call {e.get('library_call_ms')} ms), "
            f"max abs err "
            f"{e['max_abs_err']:.3g}{extra} (tolerance: {e['tolerance']}), "
            f"launches {e['launches']}")


# ---------------------------------------------------------------------------
# correctness of the RWKV path at full width, in float32
# ---------------------------------------------------------------------------

def rwkv_fp32_phase(torch, dev, rehearse):
    """The kernel path (pallas) against the chunked plain path (xla_flash)
    on the same float32 weights, both fed the same tokens: two prompts,
    prefill then decode steps; and the kernel path's decode against a full
    forward over prompt + generated tokens.  atol 2e-2 (the JAX model
    test's decode-vs-full tolerance)."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = rwkv_config(rehearse, attn_impl="pallas", dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="xla_flash")
    n_prompt, n_dec = (32, 3) if rehearse else (RWKV_FP32_PROMPT,
                                                RWKV_FP32_DECODE)
    params = M.init_params(torch.Generator(dev).manual_seed(SEED + 1), cfg,
                           device=dev)
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (2, n_prompt)), device=dev)
    caches = {c.attn_impl: SV.init_cache(c, 2, n_prompt + n_dec, device=dev)
              for c in (cfg, plain)}
    last = {}
    for c in (cfg, plain):
        last[c.attn_impl], caches[c.attn_impl], _ = SV.prefill(
            params, c, prompts, cache=caches[c.attn_impl])
    toks = [last["pallas"].argmax(-1)]
    worst = float((last["pallas"] - last["xla_flash"]).abs().max())
    for _ in range(n_dec):
        for c in (cfg, plain):
            last[c.attn_impl], caches[c.attn_impl] = SV.decode_step(
                params, c, toks[-1][:, None], cache=caches[c.attn_impl])
        worst = max(worst, float((last["pallas"] - last["xla_flash"]).abs()
                                 .max()))
        toks.append(last["pallas"].argmax(-1))
    check(worst <= 2e-2, f"rwkv fp32: kernel path differs from the plain "
          f"path (max abs err {worst}, tol 2e-2)")
    seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
    full = M.forward(params, cfg, seq).logits[:, -1]
    d_err = float((full - last["pallas"]).abs().max())
    check(d_err <= 2e-2, f"rwkv fp32: decode differs from the full "
          f"forward (max abs err {d_err}, tol 2e-2)")
    check(bool(torch.isfinite(full).all()), "rwkv fp32: logits not finite")
    return [f"rwkv float32 ({cfg.n_layers} layers, d_model {cfg.d_model}): "
            f"2 prompts x {n_prompt} tokens + {n_dec} decode steps, kernel "
            f"path vs chunked plain path max abs err {worst:.3g} over every "
            f"step's logits; decode vs full forward over {seq.shape[1]} "
            f"tokens max abs err {d_err:.3g} (tol 2e-2)"]


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU at a tiny size (plain "
                         "versions instead of kernels, no result line)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeError(f"no src/repro_torch beside {__file__}: run from "
                         f"a checkout of the repository")
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.kernels import build

    if args.rehearse:
        dev = torch.device("cpu")
    else:
        check(torch.cuda.is_available(), "torch finds no CUDA device")
        dev = torch.device("cuda")
        print(gpu_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in ptxas_lines(libs):
            print(line, flush=True)

    scene, trunk, spec = configure(args.rehearse)
    tf, lines = training_phase(torch, dev, scene, trunk, spec,
                               args.rehearse)
    for line in lines:
        print(line, flush=True)
    params = tf.params
    serve = dataclasses.replace(
        tf, trunk_cfg=dataclasses.replace(trunk, attn_impl="pallas"))
    data = collect(VideoStream(scene, dynamics_seed=SEED), N_FRAMES)

    qkv, feat, grids, rows = kernel_inputs(torch, dev, trunk, spec, params,
                                           data)
    if args.rehearse:
        entries = []
    else:
        entries, sweep = kernel_phase(torch, dev, feat, params, grids, rows)
        flash, flash_lines = flash_phase(torch, qkv)
        entries.append(flash)
        for e in entries:
            print(f"kernel {e['name']} {e['shape']}: device {e['ms']:.4f} "
                  f"ms (call {e['call_ms']:.4f} ms, back-to-back "
                  f"{e['b2b_ms']:.4f} ms; plain {e['plain_ms']:.4f} ms, "
                  f"bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
                  f"library device {e['library_ms']} ms, call "
                  f"{e.get('library_call_ms')} ms), max abs err "
                  f"{e['max_abs_err']:.3g}", flush=True)
        for e in entries[:2]:
            print(f"kernel {e['name']} before, on the grid sliced to "
                  f"classes {e['classes']}: device {e['sliced_ms']:.5f} ms, "
                  f"call {e['sliced_call_ms']:.5f} ms, back-to-back "
                  f"{e['sliced_b2b_ms']:.5f} ms; gather + .contiguous() + "
                  f"kernel: device {e['compose_ms']:.5f} ms, call "
                  f"{e['compose_call_ms']:.5f} ms, back-to-back "
                  f"{e['compose_b2b_ms']:.5f} ms", flush=True)
        for line in sweep:
            print(line, flush=True)
        for line in flash_lines:
            print(line, flush=True)
    del qkv, feat, grids, rows
    print(plain_head_check(torch, dev, trunk, spec, params, data),
          flush=True)

    runs, record, launches, peak = main_path(torch, dev, scene, serve, data)
    print(f"main path launches: {launches}", flush=True)
    print(f"serving peak device memory (both passes, pallas trunk): "
          f"{gib(peak)}", flush=True)
    for line in check_main_path(torch, data, scene, runs, record):
        print(line, flush=True)
    for line in trunk_compare(torch, dev, tf, serve, data):
        print(line, flush=True)
    if not args.rehearse:
        check(peak < SERVING_PEAK_LIMIT, f"serving peak {gib(peak)} is not "
              f"under {gib(SERVING_PEAK_LIMIT)}")
        want = spec.layer * (N_FRAMES // BATCH)
        check(launches["flash_attention_bhsd"] == want,
              f"flash_attention_bhsd launched "
              f"{launches['flash_attention_bhsd']} times on the main path, "
              f"want {want} (one per trunk layer and batch)")
        for e in entries:
            check(launches[e["name"]] > 0,
                  f"{e['name']} was not launched on the main path")
            e["launches"] = launches[e["name"]]
    del tf, serve, params, data

    # on the CPU each timed call runs once, untimed
    if args.rehearse:
        def timer(fn):
            fn()

        def ktimer(fn, expect=None):
            fn()
            return {"ms": None, "call_ms": None, "b2b_ms": None}
    else:
        def timer(fn):
            return time_ms(torch, fn)

        def ktimer(fn, expect=None):
            return kernel_times(torch, fn, expect)
    rwkv_launches, calls, lines = rwkv_serving_phase(torch, dev,
                                                     args.rehearse)
    for line in lines:
        print(line, flush=True)
    scan, lines = rwkv_kernel_phase(torch, dev, calls, timer, ktimer)
    scan["launches"] = rwkv_launches["rwkv6_scan_bhtk"]
    del calls
    print(kernel_line(scan), flush=True)
    for line in lines:
        print(line, flush=True)
    decode, lines = decode_phase(torch, dev, timer, ktimer, args.rehearse)
    print(kernel_line(decode), flush=True)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for line in rwkv_fp32_phase(torch, dev, args.rehearse):
        print(line, flush=True)
    if args.rehearse:
        print("rehearsal done (CPU: plain versions, no kernels)")
        return 0
    entries += [scan, decode]
    for e in entries:
        e["kernel_ms"] = e["ms"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
