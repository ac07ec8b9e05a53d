"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in ~70 lines.

    python examples/torch_quickstart.py                # on a CUDA card
    python examples/torch_quickstart.py --device cpu   # anywhere

The twin of examples/quickstart.py, importing only ``repro_torch``:

1. generate a synthetic monitoring stream (Jackson-like: cars + people),
2. train an OD filter branch for a few steps (counts + location grid),
3. execute a declarative query with the filter cascade,
4. estimate an aggregate with a control variate.
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import numpy as np

from repro_torch.core import aggregates as AGG
from repro_torch.core import cascade as CS
from repro_torch.core import query as Q
from repro_torch.data.synthetic import JACKSON_LIKE, VideoStream, collect
from repro_torch.models.config import BranchSpec
from repro_torch.train.filter_train import train_filter

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# 1. stream ---------------------------------------------------------------
scene = JACKSON_LIKE
data = collect(VideoStream(scene), 512)
print(f"stream: {len(data['objects'])} frames, "
      f"{data['counts'].sum(-1).mean():.1f} objects/frame")

# 2. filter branch (paper §II-B) -------------------------------------------
spec = BranchSpec(layer=2, grid=scene.grid, n_classes=scene.n_classes,
                  kind="od", head_dim=64)
tf = train_filter(scene, spec, steps=120, n_frames=1024, device=dev)
print(f"filter trained on {dev}; final loss {np.mean(tf.losses[-10:]):.3f}")

# 3. declarative query via cascade (paper §IV-B) ---------------------------
#    "frames with >=1 car and >=1 person, car left of person"
query = Q.And((Q.ClassCount(0, Q.Op.GE, 1, tolerance=1),
               Q.ClassCount(1, Q.Op.GE, 1, tolerance=1),
               Q.Spatial(0, Q.Rel.LEFT, 1, radius=2)))
cascade = CS.FilterCascade(query)
fout = tf.apply(data["embeds"], device=dev)
ex = CS.CascadeExecutor(
    cascade, filter_fn=lambda b: fout,
    oracle_fn=lambda b, idx: [data["objects"][j] for j in idx],
    n_classes=scene.n_classes, grid=scene.grid, device=dev)
res = ex.run_batch(data["embeds"])
truth = np.array([Q.eval_objects(query, o, scene.n_classes, scene.grid)
                  for o in data["objects"]])
recall = (res.answers & truth).sum() / max(truth.sum(), 1)
print(f"cascade: selectivity {ex.stats.selectivity:.2f}, "
      f"oracle calls {ex.stats.oracle_calls}/{len(truth)}, "
      f"recall {recall:.2f}, "
      f"speedup {ex.stats.speedup_vs_full(200.0, 1.9):.1f}x "
      f"(paper cost model: 200ms oracle, 1.9ms filter)")

# 4. aggregate with a control variate (paper §III) -------------------------
y = truth.astype(float)                                # oracle answer
x_filter = Q.eval_filters(query, fout).cpu().numpy().astype(float)
est = AGG.cv_estimate(y, x_filter)
print(f"aggregate: naive mean {y.mean():.4f}, CV mean {est.mean:.4f}, "
      f"variance reduction {est.variance_reduction:.1f}x, "
      f"95% CI ±{1.96*np.sqrt(est.var):.4f}")
print("quickstart OK")
