"""Synthetic video streams with ground truth.

The paper's datasets (Coral / Jackson / Detrac, Table II) are not
redistributable, so benchmarks generate streams with *matched statistics*
(objects/frame mean & std, number of classes, class skew) and exact ground
truth.  Objects persist across frames and move smoothly (single static
camera, like the paper's fixed-angle sequences), so filter tasks have the
same temporal structure as real monitoring video.

The "frontend stub" renders a frame to patch embeddings: each world-grid
cell emits a D-dim embedding = background + sum of class prototypes present
+ noise.  This mirrors the assignment rule that modality frontends are
stubs providing precomputed frame/patch embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str = "jackson-like"
    n_classes: int = 2
    class_probs: Tuple[float, ...] = (0.8, 0.2)
    grid: int = 8                   # world/occupancy grid g
    mean_objects: float = 1.2       # Table II Obj/Frame
    std_objects: float = 0.5
    persistence: float = 0.95       # per-frame survival prob
    speed: float = 0.4              # cells/frame
    d_embed: int = 64               # stub frontend embedding width
    noise: float = 0.35
    seed: int = 0


# Table II-matched presets
CORAL_LIKE = SceneConfig(name="coral-like", n_classes=1, class_probs=(1.0,),
                         mean_objects=8.7, std_objects=5.1, grid=8, seed=1)
JACKSON_LIKE = SceneConfig(name="jackson-like", n_classes=2,
                           class_probs=(0.8, 0.2), mean_objects=1.2,
                           std_objects=0.5, grid=8, seed=2)
DETRAC_LIKE = SceneConfig(name="detrac-like", n_classes=3,
                          class_probs=(0.92, 0.06, 0.02), mean_objects=15.8,
                          std_objects=9.8, grid=8, seed=3)
PRESETS = {c.name: c for c in (CORAL_LIKE, JACKSON_LIKE, DETRAC_LIKE)}


@dataclasses.dataclass
class Frame:
    objects: np.ndarray            # (N, 3) rows (cls, row, col) ints
    counts: np.ndarray             # (C,) per-class counts
    occupancy: np.ndarray          # (g, g, C) bool
    embeds: np.ndarray             # (g*g, D) float32 patch embeddings


class VideoStream:
    """Deterministic synthetic stream of ``Frame``s.

    ``cfg.seed`` fixes the *camera/world* (class prototypes, background) —
    train and test streams of one scene must share it.  ``dynamics_seed``
    varies object trajectories/noise (train vs held-out test streams).
    """

    def __init__(self, cfg: SceneConfig, dynamics_seed: int = 0):
        self.cfg = cfg
        world_rng = np.random.default_rng(cfg.seed)
        self.rng = np.random.default_rng(
            (cfg.seed + 1) * 7919 + dynamics_seed)
        # class prototype vectors for the stub frontend (world-seeded)
        self.protos = world_rng.normal(
            0, 1, (cfg.n_classes, cfg.d_embed)).astype(np.float32)
        self.background = world_rng.normal(
            0, 0.2, (cfg.grid * cfg.grid, cfg.d_embed)).astype(np.float32)
        # object state: cls, row(float), col(float), vr, vc
        self._obj = np.zeros((0, 5), np.float64)
        # birth rate chosen so steady-state count ~= mean_objects,
        # accounting for the burst arrivals (0.02 * std per frame)
        self.birth_rate = max(
            cfg.mean_objects * (1 - cfg.persistence) - 0.02 * cfg.std_objects,
            0.01)

    def _step_dynamics(self):
        cfg, rng = self.cfg, self.rng
        if len(self._obj):
            keep = rng.random(len(self._obj)) < cfg.persistence
            self._obj = self._obj[keep]
            self._obj[:, 1:3] += self._obj[:, 3:5]
            # bounce at borders
            for d in (1, 2):
                lo = self._obj[:, d] < 0
                hi = self._obj[:, d] > cfg.grid - 1
                self._obj[lo, d] = -self._obj[lo, d]
                self._obj[hi, d] = 2 * (cfg.grid - 1) - self._obj[hi, d]
                self._obj[lo | hi, d + 2] *= -1
        n_new = rng.poisson(self.birth_rate)
        # burstiness to match std: occasional group arrivals
        if rng.random() < 0.02:
            n_new += rng.poisson(self.cfg.std_objects)
        if n_new:
            cls = rng.choice(cfg.n_classes, n_new, p=cfg.class_probs)
            pos = rng.uniform(0, cfg.grid - 1, (n_new, 2))
            vel = rng.normal(0, cfg.speed, (n_new, 2))
            self._obj = np.concatenate(
                [self._obj,
                 np.column_stack([cls.astype(np.float64), pos, vel])], 0)

    def _render(self, objects: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        emb = self.background.copy()
        for cls, r, c in objects:
            cell = int(r) * cfg.grid + int(c)
            emb[cell] += self.protos[int(cls)]
        emb += self.rng.normal(0, cfg.noise, emb.shape).astype(np.float32)
        return emb

    def frames(self, n: int, warmup: int = 50) -> Iterator[Frame]:
        for _ in range(warmup):
            self._step_dynamics()
        cfg = self.cfg
        for _ in range(n):
            self._step_dynamics()
            objs = np.column_stack([
                self._obj[:, 0],
                np.clip(np.round(self._obj[:, 1]), 0, cfg.grid - 1),
                np.clip(np.round(self._obj[:, 2]), 0, cfg.grid - 1),
            ]).astype(np.int64) if len(self._obj) else np.zeros((0, 3), np.int64)
            counts = np.bincount(objs[:, 0], minlength=cfg.n_classes)
            occ = np.zeros((cfg.grid, cfg.grid, cfg.n_classes), bool)
            for cls, r, c in objs:
                occ[r, c, cls] = True
            yield Frame(objects=objs, counts=counts.astype(np.float32),
                        occupancy=occ, embeds=self._render(objs))


def collect(stream: VideoStream, n: int) -> Dict[str, np.ndarray]:
    """Materialise n frames into batched arrays (+ ragged object lists)."""
    frames = list(stream.frames(n))
    return {
        "embeds": np.stack([f.embeds for f in frames]),
        "counts": np.stack([f.counts for f in frames]),
        "occupancy": np.stack([f.occupancy for f in frames]),
        "objects": [f.objects for f in frames],
    }


def class_weights(counts: np.ndarray) -> np.ndarray:
    """Paper Eq. 2 weight_c: fraction of training frames containing class c."""
    present = (counts > 0).mean(0)
    return (present / max(present.sum(), 1e-9)).astype(np.float32)
