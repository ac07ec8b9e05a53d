"""Monitoring aggregates with control variates on the PyTorch/CUDA port
(paper §III demo), the twin of examples/aggregate_cv.py.

Estimates "fraction of frames where a car is in the lower-right quadrant"
(a1-style) three ways — naive sampling, single CV, multiple CV — and
shows the variance/CI shrink while the mean stays unbiased.  Then pools
per-stream float64 accumulators on the device (``merge`` and the
three-sum ``distributed_reduce``) and runs the same aggregate as an
error-bounded contract (``ContractExecutor``).

    python examples/torch_aggregate_cv.py                # on a CUDA card
    python examples/torch_aggregate_cv.py --device cpu   # anywhere
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core import aggregates as AGG
from repro_torch.core import query as Q
from repro_torch.core.contracts import (AggregateQuery, ContractExecutor,
                                        make_value_fn)
from repro_torch.data.synthetic import DETRAC_LIKE, VideoStream, collect
from repro_torch.models.config import BranchSpec
from repro_torch.train.filter_train import train_filter

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

scene = DETRAC_LIKE
g = scene.grid
n_frames, n_samples = 2048, 400

print(f"training OD filter on detrac-like stream ({dev})...")
spec = BranchSpec(layer=2, grid=g, n_classes=scene.n_classes, kind="od",
                  head_dim=64)
tf = train_filter(scene, spec, steps=200, n_frames=1536, device=dev)
data = collect(VideoStream(scene), n_frames)
fout = tf.apply(data["embeds"], device=dev)

region_q = Q.Region(0, (g // 2, g // 2, g, g))
count_q = Q.Count(Q.Op.GE, 3)
target = Q.And((region_q, count_q))

rng = np.random.default_rng(0)
idx = rng.choice(n_frames, n_samples, replace=False)

# oracle answers (Y) on the sample
y = np.array([float(Q.eval_objects(target, data["objects"][i],
                                   scene.n_classes, g)) for i in idx])
# filter answers (controls, Z), over every frame (their exact means)
z_region_all = Q.eval_filters(Q.Region(0, (g // 2, g // 2, g, g), radius=1),
                              fout).cpu().numpy().astype(float)
z_count_all = Q.eval_filters(Q.Count(Q.Op.GE, 3, tolerance=1),
                             fout).cpu().numpy().astype(float)
z_region, z_count = z_region_all[idx], z_count_all[idx]

true_mean = np.mean([float(Q.eval_objects(target, o, scene.n_classes, g))
                     for o in data["objects"]])

naive_var = y.var(ddof=1) / len(y)
single = AGG.cv_estimate(y, z_region)
multi = AGG.mcv_estimate(y, np.stack([z_region, z_count], 1))

print(f"\npopulation mean (all {n_frames} frames): {true_mean:.4f}")
print(f"{'estimator':18s} {'mean':>8s} {'var':>12s} {'reduction':>10s} "
      f"{'95% CI':>16s}")
for name, mean, var in [("naive", y.mean(), naive_var),
                        ("single CV", single.mean, single.var),
                        ("multiple CV", multi.mean, multi.var)]:
    h = 1.96 * np.sqrt(var)
    print(f"{name:18s} {mean:8.4f} {var:12.3e} {naive_var/var:9.1f}x "
          f"[{mean-h:.4f}, {mean+h:.4f}]")

# per-stream float64 accumulators on the device, pooled two ways
z2 = np.stack([z_region, z_count], 1)
accs = [AGG.CVAccumulator.init(2, device=dev).update(y[s], z2[s])
        for s in np.array_split(np.arange(len(y)), 4)]
merged = accs[0]
for a in accs[1:]:
    merged = merged.merge(a)
reduced = AGG.distributed_reduce(accs)
est = merged.estimate()
print(f"\n4-stream accumulators on {merged.M2.device} "
      f"({merged.M2.dtype}): merged mean {est.mean:.4f}, "
      f"distributed_reduce mean {reduced.estimate().mean:.4f} "
      f"(match multiple CV: {abs(est.mean - multi.mean) < 1e-9})")

# the same aggregate as an accuracy contract: +-10% at 95%
q = AggregateQuery(pred=target, agg="count", eps=0.1)
res = ContractExecutor(
    q, make_value_fn(q, lambda f: [data["objects"][int(i)] for i in f],
                     scene.n_classes, g), n_frames,
    verdict_fn=lambda f: np.stack([z_region_all[f], z_count_all[f]], 1),
    seed=0, device=dev).run()
print(f"contract COUNT ±10% @ 95%: estimate {res.estimate:.1f} "
      f"[{res.ci[0]:.1f}, {res.ci[1]:.1f}] (truth "
      f"{true_mean * n_frames:.0f}), {res.oracle_calls} oracle calls of "
      f"{n_frames}, terminated by {res.terminated}")
