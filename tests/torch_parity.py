"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed: weights
move across as numpy arrays (the two RNGs cannot agree), query ASTs are
converted field by field, and filter outputs are handed to both as the
same arrays.
"""
import numpy as np
import torch

from repro.core import query as RQ
from repro_torch.core import query as TQ

# relative/absolute tolerances of the float paths (matmuls summed in
# another order than XLA's), as tests/test_kernels.py holds them
RTOL, ATOL = 1e-4, 1e-3


def to_numpy_tree(tree):
    """JAX parameter pytree (nested dicts) -> nested dict of numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_port(q):
    """JAX-package query AST -> the port's, field by field."""
    if isinstance(q, (RQ.And, RQ.Or)):
        cls = TQ.And if isinstance(q, RQ.And) else TQ.Or
        return cls(tuple(to_port(t) for t in q.terms))
    if isinstance(q, RQ.Not):
        return TQ.Not(to_port(q.term))
    if isinstance(q, RQ.Count):
        return TQ.Count(TQ.Op(q.op.value), q.value, q.tolerance)
    if isinstance(q, RQ.ClassCount):
        return TQ.ClassCount(q.cls, TQ.Op(q.op.value), q.value, q.tolerance)
    if isinstance(q, RQ.Spatial):
        return TQ.Spatial(q.cls_a, TQ.Rel(q.rel.value), q.cls_b, q.radius)
    if isinstance(q, RQ.Region):
        return TQ.Region(q.cls, tuple(q.rect), q.min_count, q.radius)
    raise TypeError(q)


def rand_leaf(rng, C, grid, *, relaxed=True):
    """Seeded random JAX-package leaf predicate."""
    tol = int(rng.integers(0, 3)) if relaxed else 0
    rad = int(rng.integers(0, 3)) if relaxed else 0
    op = [RQ.Op.EQ, RQ.Op.GE, RQ.Op.LE][rng.integers(0, 3)]
    kind = rng.integers(0, 4)
    if kind == 0:
        return RQ.Count(op, int(rng.integers(0, 7)), tol)
    if kind == 1:
        return RQ.ClassCount(int(rng.integers(0, C)), op,
                             int(rng.integers(0, 5)), tol)
    if kind == 2:
        return RQ.Spatial(int(rng.integers(0, C)),
                          list(RQ.Rel)[rng.integers(0, 4)],
                          int(rng.integers(0, C)), rad)
    r0, c0 = (int(x) for x in rng.integers(0, 3, 2))
    return RQ.Region(int(rng.integers(0, C)),
                     (r0, c0, int(rng.integers(3, grid + 1)),
                      int(rng.integers(3, grid + 1))),
                     int(rng.integers(1, 3)), rad)


def rand_query(rng, C, grid, depth=0, *, relaxed=True):
    """Seeded random JAX-package query tree (And/Or/Not over leaves)."""
    if depth >= 3 or rng.random() < 0.4:
        return rand_leaf(rng, C, grid, relaxed=relaxed)
    kind = rng.integers(0, 3)
    if kind == 2:
        return RQ.Not(rand_query(rng, C, grid, depth + 1, relaxed=relaxed))
    terms = tuple(rand_query(rng, C, grid, depth + 1, relaxed=relaxed)
                  for _ in range(rng.integers(2, 4)))
    return RQ.And(terms) if kind == 0 else RQ.Or(terms)


def outputs_pair(counts: np.ndarray, grid):
    """The same filter-output arrays as a JAX and a port FilterOutputs."""
    import jax.numpy as jnp
    from repro.core.filters import FilterOutputs as RF
    from repro_torch.core.filters import FilterOutputs as TF
    return (RF(counts=jnp.asarray(counts),
               grid=None if grid is None else jnp.asarray(grid)),
            TF(counts=torch.as_tensor(counts),
               grid=None if grid is None else torch.as_tensor(grid)))


def report_fields(rep):
    """The StageReport fields both packages must agree on."""
    return {k: getattr(rep, k) for k in
            ("order", "ran", "skipped", "bodies", "rows_evaluated",
             "undecided_rows_in", "undecided_after", "steps_compiled",
             "batch", "cost_run", "cost_total")}


def assert_close(port_t, ref_a, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port_t.detach().cpu().numpy(),
                               np.asarray(ref_a), rtol=rtol, atol=atol)

