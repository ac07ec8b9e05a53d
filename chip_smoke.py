#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse # the same phases, tiny, on the CPU

Phases (any failure exits non-zero and prints no result line):

1. The card's name and power limit (nvidia-smi); build the CUDA kernels
   of src/repro_torch/kernels/csrc with nvcc, one process per source.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes: the two spatial-stats kernels bit for bit
   (``torch.equal``; the row kernel on an unsorted row list with
   duplicates), the CAM head at 1e-4.  Each is timed with CUDA events
   (median of 25) beside its plain version, a library yardstick where
   one PyTorch call computes the same function, and its bound.
3. The main path at full width: the detrac-like scene at the paper's
   g = 56, the 4-layer d_model 128 filter trunk with the IC head (random
   weights from a seeded generator), 256 frames in batches of 32 through
   MultiQueryStreamExecutor -> MultiQueryExecutor ->
   MultiQueryCascade(adaptive=True), queries registered and retired
   mid-stream; then the same batches with ground-truth filter outputs,
   where the count tier decides most rows and the compacted spatial
   stage runs the row kernel.  Launch counts are reset just before and
   read just after; every kernel must have run, the staged masks must
   equal the exhaustive plan's bit for bit, the answers must equal the
   exact oracle semantics, and the kernel head must match the plain head.
4. A ``kernels`` JSON line, then the device line as the last line.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
N_FRAMES, BATCH, WINDOW = 256, 32, 128
SEED = 0


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


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def configure(rehearse):
    from repro_torch.data.synthetic import DETRAC_LIKE
    from repro_torch.models.config import BranchSpec
    from repro_torch.train.filter_train import default_trunk
    g = 16 if rehearse else 56
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
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = staged_masks(out, presumed_decided)
            if dev.type == "cuda":
                torch.cuda.synchronize()
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
    if dev.type == "cuda":
        torch.cuda.synchronize()
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


def main_path(torch, dev, scene, trunk, spec, params, data):
    """Both passes of the stream; returns what the checks and the report
    need.  Launch counts cover exactly these two passes."""
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.kernels import ops
    from repro_torch.train.filter_train import filter_forward
    embeds = torch.as_tensor(data["embeds"], device=dev)
    gt_counts = torch.as_tensor(data["counts"].astype("float32"), device=dev)
    gt_grid = torch.as_tensor(data["occupancy"], device=dev).float()

    def learned(idx):
        return filter_forward(params, trunk, spec,
                              embeds[torch.as_tensor(idx, device=dev)],
                              use_kernel=True, device=dev)

    def ground_truth(idx):
        i = torch.as_tensor(idx, device=dev)
        return FilterOutputs(counts=gt_counts[i], grid=gt_grid[i])

    record = {"learned": [], "ground_truth": []}
    runs = {}
    ops.reset_launch_counts()
    for name, fn in (("learned", learned), ("ground_truth", ground_truth)):
        runs[name] = run_stream(torch, dev, data, scene, fn, record[name])
    launches = ops.launch_counts()
    return runs, record, launches


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
    """The main path's kernel inputs for the first batch: the CAM head's
    features, and the ground-truth grid sliced to the two classes the
    first window's spatial stage reads (contiguous, as the planner
    passes it)."""
    from repro_torch.core import cam as CAM
    from repro_torch.models import model as M
    e = torch.as_tensor(data["embeds"][:BATCH], device=dev)
    x = torch.einsum("bpd,de->bpe", e, params["proj"])
    x = x + params["pos"][: x.shape[1]][None]
    tap = M.forward(params["trunk"], trunk, embeds=x, tap_layer=spec.layer,
                    stop_at_tap=True, causal=False).tap
    feat = CAM.spatialize(tap.float(), spec.grid)
    feat = torch.relu(torch.einsum("bijd,de->bije", feat,
                                   params["branch"]["proj"]))
    B, g, _, D = feat.shape
    feat = feat.reshape(B, g * g, D).contiguous()
    grid = torch.as_tensor(data["occupancy"][:BATCH], device=dev).float()
    grid = grid[..., torch.tensor([0, 1], device=dev)].contiguous()
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.randint(0, BATCH, (16,), generator=gen)
    rows[-4:] = rows[-5]                         # bucket-style padding
    return feat, grid, rows.to(dev)


def kernel_phase(torch, dev, feat, params, grid, rows):
    from repro_torch.kernels import cam_head as CH
    from repro_torch.kernels import spatial_predicate as SP
    w = params["branch"]["w"].contiguous()
    b = params["branch"]["b"].contiguous()
    entries = []

    s_k = SP.spatial_stats_bgc(grid)
    s_p = SP.spatial_stats_plain(grid)
    check(torch.equal(s_k, s_p), "spatial_stats_bgc differs from plain")
    B, g, _, C = grid.shape
    bnd, by = bound_ms(B * g * g * C * 4 + B * C * 5 * 4, B * g * g * C)
    entries.append({
        "name": "spatial_stats_bgc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spatial_stats.cu",
        "replaces": "src/repro/kernels/spatial_predicate.py:44",
        "max_abs_err": float((s_k - s_p).abs().max()),
        "ms": time_ms(torch, lambda: SP.spatial_stats_bgc(grid)),
        "plain_ms": time_ms(torch, lambda: SP.spatial_stats_plain(grid)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": [B, g, g, C]})

    r_k = SP.spatial_stats_rows_bgc(grid, rows)
    r_p = SP.spatial_stats_rows_plain(grid, rows)
    check(torch.equal(r_k, r_p), "spatial_stats_rows_bgc differs from plain")
    R, U = rows.numel(), int(torch.unique(rows).numel())
    bnd, by = bound_ms(U * g * g * C * 4 + R * 8 + R * C * 5 * 4,
                       U * g * g * C)
    entries.append({
        "name": "spatial_stats_rows_bgc", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spatial_stats.cu",
        "replaces": "src/repro/kernels/spatial_predicate.py:66",
        "max_abs_err": float((r_k - r_p).abs().max()),
        "ms": time_ms(torch, lambda: SP.spatial_stats_rows_bgc(grid, rows)),
        "plain_ms": time_ms(torch,
                            lambda: SP.spatial_stats_rows_plain(grid, rows)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": [B, g, g, C, R]})

    c_k, m_k = CH.cam_head_bgd(feat, w, b)
    c_p, m_p = CH.cam_head_plain(feat, w, b)
    err = max(float((c_k - c_p).abs().max()), float((m_k - m_p).abs().max()))
    check(torch.allclose(m_k, m_p, rtol=1e-4, atol=1e-4)
          and torch.allclose(c_k, c_p, rtol=1e-4, atol=1e-4),
          f"cam_head_bgd differs from plain (max abs err {err})")
    Bf, P, D = feat.shape
    Cw = w.shape[1]
    bnd, by = bound_ms(Bf * P * D * 4 + D * Cw * 4 + Cw * 4 + Bf * Cw * 4
                       + Bf * P * Cw * 4, 2 * Bf * P * D * Cw)
    entries.append({
        "name": "cam_head_bgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_head.cu",
        "replaces": "src/repro/kernels/cam_head.py:49",
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: CH.cam_head_bgd(feat, w, b)),
        "plain_ms": time_ms(torch, lambda: CH.cam_head_plain(feat, w, b)),
        "bound_ms": bnd, "bound_by": by,
        "library_ms": time_ms(torch, lambda: torch.matmul(feat, w)),
        "shape": [Bf, P, D, Cw]})
    return entries


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
    from repro_torch.train.filter_train import init_filter_model

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

    scene, trunk, spec = configure(args.rehearse)
    data = collect(VideoStream(scene, dynamics_seed=SEED), N_FRAMES)
    gen = torch.Generator().manual_seed(SEED)
    params = init_filter_model(gen, trunk, spec, scene.d_embed, device=dev)

    feat, grid, rows = kernel_inputs(torch, dev, trunk, spec, params, data)
    if args.rehearse:
        entries = []
    else:
        entries = kernel_phase(torch, dev, feat, params, grid, rows)
        for e in entries:
            print(f"kernel {e['name']} {e['shape']}: {e['ms']:.4f} ms "
                  f"(plain {e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f}"
                  f" ms by {e['bound_by']}, library {e['library_ms']}), "
                  f"max abs err {e['max_abs_err']:.3g}", flush=True)
    print(plain_head_check(torch, dev, trunk, spec, params, data),
          flush=True)

    runs, record, launches = main_path(torch, dev, scene, trunk, spec,
                                       params, data)
    print(f"main path launches: {launches}", flush=True)
    for line in check_main_path(torch, data, scene, runs, record):
        print(line, flush=True)
    if args.rehearse:
        print("rehearsal done (CPU: plain versions, no kernels)")
        return 0
    for e in entries:
        check(launches[e["name"]] > 0,
              f"{e['name']} was not launched on the main path")
        e["launches"] = launches[e["name"]]
        e["kernel_ms"] = e["ms"]
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB", flush=True)
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
