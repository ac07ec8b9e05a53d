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
    if isinstance(q, RQ.Duration):
        return TQ.Duration(to_port(q.pred), q.min_frames)
    if isinstance(q, RQ.Sequence):
        return TQ.Sequence(to_port(q.first), to_port(q.then), q.within)
    if isinstance(q, RQ.SlidingCount):
        return TQ.SlidingCount(to_port(q.pred), q.window, TQ.Op(q.op.value),
                               q.value)
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



def tf32(x):
    """TF32 rounding of float32 values (round to nearest, ties away from
    zero, at 10 mantissa bits), as ``cvt.rna.tf32.f32`` and the kernels'
    integer split (add half an ulp, clear the low 13 bits) do."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tc_step(d, a, b):
    """One tensor-core k-step, ``d + a b^T`` for a (M, K), b (N, K) values
    exact in the operand type (TF32 with K 8, bf16 with K 16) and d (M, N)
    float32, as a block FMA of the tensor cores: the K products are
    exact, they and d are aligned to the largest of them and truncated to
    its 24 significant bits, summed, and the sum truncated to float32
    (round toward zero), the model of Fasi et al., "Numerical behavior of
    NVIDIA tensor cores" (PeerJ CS, 2021)."""
    t = np.concatenate([d[:, :, None].astype(np.float64),
                        a[:, None, :].astype(np.float64) * b[None, :, :]],
                       axis=2)
    _, e = np.frexp(np.abs(t).max(axis=2, keepdims=True))
    ulp = np.ldexp(1.0, e - 24)
    total = (np.trunc(t / ulp) * ulp).sum(axis=2)
    out = total.astype(np.float32)
    over = np.abs(out) > np.abs(total)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def bf16(x):
    """float32 values rounded to bf16 (to nearest even), as float32."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()
