"""The port's error-feedback int8 gradient compression against the JAX
package's (``distributed/compression.py``), on the CPU.

The three cases of ``tests/test_distributed.py`` as twins: the same
gradients go through both packages, the int8 payloads must be equal bit
for bit and the scales, residuals and dequantised values within 1e-7
(float32 arithmetic of one order; XLA may contract ``gf - q * scale``
into one fused multiply-add).  The all-reduce runs over a one-rank gloo
group against the reference's one-device ``shard_map``, and over two
gloo ranks in subprocesses: the mean of the two workers' gradients
within the sum of their ``scale / 2`` (their largest |g| made equal, so
the scales agree: the reference's mean of scales is exact only then).
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.distributed import compression as RCOMP
from repro_torch.distributed import compression as TCOMP

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FTOL = 1e-7


def _pair(tree):
    """A numpy tree as the reference's arrays and the port's tensors."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree))


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compress_roundtrip_small_error():
    g = {"w": np.linspace(-1, 1, 100, dtype=np.float32).reshape(10, 10),
         "b": {"c": np.random.default_rng(0).normal(0, 1e-3, 37)
               .astype(np.float32)}}
    rg, tg = _pair(g)
    rq, rs, re = RCOMP.compress(rg, RCOMP.init_error_state(rg))
    tq, ts, te = TCOMP.compress(tg, TCOMP.init_error_state(tg))
    deq = TCOMP.decompress(tq, ts)
    for path in (("w",), ("b", "c")):
        def at(t):
            for k in path:
                t = t[k]
            return t
        assert at(tq).dtype == torch.int8 and at(te).dtype == torch.float32
        np.testing.assert_array_equal(at(tq).numpy(), np.asarray(at(rq)))
        np.testing.assert_allclose(float(at(ts)), float(at(rs)), rtol=0,
                                   atol=FTOL)
        np.testing.assert_allclose(at(te).numpy(), np.asarray(at(re)),
                                   rtol=0, atol=FTOL)
        # the reference's own checks, on the port
        err = (at(deq) - at(tg)).abs().max()
        assert float(err) <= float(at(ts)) * 0.5 + 1e-7
        # error feedback stores exactly the residual
        np.testing.assert_allclose(at(te).numpy(),
                                   (at(tg) - at(deq)).numpy(), atol=1e-7)


def test_error_feedback_unbiased_over_steps():
    """Constant gradient: the mean of 50 dequantised steps follows the
    gradient, and each step's payload equals the reference's."""
    g = {"w": np.array([0.301, -0.7003, 0.11], np.float32)}
    rg, tg = _pair(g)
    rerr, terr = RCOMP.init_error_state(rg), TCOMP.init_error_state(tg)
    acc = torch.zeros(3)
    for _ in range(50):
        rq, rs, rerr = RCOMP.compress(rg, rerr)
        tq, ts, terr = TCOMP.compress(tg, terr)
        np.testing.assert_array_equal(tq["w"].numpy(), np.asarray(rq["w"]))
        np.testing.assert_allclose(terr["w"].numpy(), np.asarray(rerr["w"]),
                                   rtol=0, atol=FTOL)
        acc = acc + TCOMP.decompress(tq, ts)["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g["w"], atol=1e-3)


def test_allreduce_compressed_single_device(one_rank_group):
    g = {"w": (np.arange(8.0, dtype=np.float32) / 7 - 0.5),
         "t": np.random.default_rng(1).normal(0, 1, (6, 4)).astype(np.float32)}
    rg, tg = _pair(g)
    tg["t"] = torch.as_tensor(g["t"].T.copy()).T     # a strided gradient
    assert not tg["t"].is_contiguous()
    from repro.distributed.sharding import shard_map
    mesh = jax.make_mesh((1,), ("data",))
    rout, rerr = shard_map(
        lambda gg, ee: RCOMP.allreduce_compressed(gg, ee, "data"),
        mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        check_vma=False)(rg, RCOMP.init_error_state(rg))
    tout, terr = TCOMP.allreduce_compressed(tg, TCOMP.init_error_state(tg),
                                            group=one_rank_group)
    np.testing.assert_allclose(tout["w"].numpy(), g["w"], atol=0.01)
    np.testing.assert_allclose(tout["w"].numpy(), np.asarray(rout["w"]),
                               rtol=0, atol=FTOL)
    np.testing.assert_allclose(terr["w"].numpy(), np.asarray(rerr["w"]),
                               rtol=0, atol=FTOL)
    assert tout["t"].is_contiguous()
    np.testing.assert_allclose(tout["t"].numpy(), np.asarray(rout["t"]),
                               rtol=0, atol=FTOL)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compression as C
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=2, rank=rank)
    rng = np.random.default_rng(100 + rank)
    a = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    c = rng.normal(0, 1e-2, 17).astype(np.float32)
    # the same largest |g| on both ranks, so the scales agree (the
    # reference's mean is exact in that case)
    a[rank, 0], c[3] = 1.5, -0.1
    g = {"a": torch.as_tensor(a), "b": {"c": torch.as_tensor(c)}}
    mean, err = C.allreduce_compressed(g, C.init_error_state(g))
    _, scales, _ = C.compress(g, C.init_error_state(g))
    np.savez(out, a=g["a"].numpy(), c=g["b"]["c"].numpy(),
             mean_a=mean["a"].numpy(), mean_c=mean["b"]["c"].numpy(),
             sa=float(scales["a"]), sc=float(scales["b"]["c"]))
    dist.destroy_process_group()
""")


def test_allreduce_compressed_two_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), store,
                               outs[r]], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=120)
        assert p.returncode == 0, log
    w = [np.load(o) for o in outs]
    for leaf, s in (("a", "sa"), ("c", "sc")):
        want = (w[0][leaf] + w[1][leaf]) / 2
        bound = (w[0][s] + w[1][s]) / 2 + 1e-7
        assert w[0][s] == w[1][s]
        for r in range(2):          # every rank holds the same mean
            np.testing.assert_array_equal(w[r]["mean_" + leaf],
                                          w[0]["mean_" + leaf])
        assert np.abs(w[0]["mean_" + leaf] - want).max() <= bound
