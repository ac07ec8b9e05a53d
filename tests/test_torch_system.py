"""End-to-end system test of the port: the paper's full pipeline on a
live stream, the twin of tests/test_system.py on ``device="cpu"``.

Train an OD filter branch on a synthetic monitoring stream, execute a
declarative count+spatial query through the cascade, verify the answers
against exact ground truth, and check the control-variate aggregate —
the complete §II + §III + §IV loop, at the reference's configuration and
seed and with every gate of the reference.
"""
import numpy as np

from repro_torch.core import aggregates as AGG
from repro_torch.core import cascade as CS
from repro_torch.core import query as Q
from repro_torch.data.synthetic import JACKSON_LIKE, VideoStream, collect
from repro_torch.models.config import BranchSpec
from repro_torch.train.filter_train import evaluate_filter, train_filter


def test_end_to_end_monitoring_pipeline():
    scene = JACKSON_LIKE
    spec = BranchSpec(layer=2, grid=scene.grid, n_classes=scene.n_classes,
                      kind="od", head_dim=48)
    tf = train_filter(scene, spec, steps=140, batch=32, n_frames=768,
                      device="cpu")

    # filter quality gates (well below the converged numbers, but enough
    # to prove learning happened)
    res = evaluate_filter(tf, scene, n_frames=256, device="cpu")
    assert res["cf_acc_1"] > 0.6, res["cf_acc_1"]
    assert res["clf_f1_1"].mean() > 0.5, res["clf_f1_1"]

    # cascade query execution with exact-oracle verification
    data = collect(VideoStream(scene, dynamics_seed=7), 384)
    query = Q.And((Q.ClassCount(0, Q.Op.GE, 1, tolerance=1),
                   Q.ClassCount(1, Q.Op.GE, 1, tolerance=1),
                   Q.Spatial(0, Q.Rel.LEFT, 1, radius=2)))
    strict = Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                    Q.ClassCount(1, Q.Op.GE, 1),
                    Q.Spatial(0, Q.Rel.LEFT, 1)))
    cascade = CS.FilterCascade(query)
    fout = tf.apply(data["embeds"], device="cpu")
    mask = cascade.mask(fout).numpy()

    truth = np.array([Q.eval_objects(strict, o, scene.n_classes, scene.grid)
                      for o in data["objects"]])
    answers = np.zeros(len(truth), bool)
    for j in np.nonzero(mask)[0]:
        answers[j] = truth[j]           # oracle-exact on survivors
    if truth.sum() >= 5:
        recall = (answers & truth).sum() / truth.sum()
        assert recall >= 0.6, (recall, int(truth.sum()))
    # the cascade must actually skip frames (that is the paper's point)
    assert mask.mean() < 0.9

    # control-variate aggregate: variance never worse than naive
    y = truth.astype(float)
    x = Q.eval_filters(query, fout).numpy().astype(float)
    est = AGG.cv_estimate(y, x)
    assert est.var <= est.naive_var * (1 + 1e-9)
    assert est.variance_reduction >= 1.0
