"""Port kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run in the Pallas interpreter on the CPU.

On a CPU tensor each wrapper runs its plain version; the spatial stats
are held bit-exact (integer extrema and counts in float32), the CAM head
at 1e-4.  The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.cam_head import cam_head_bgd as ref_cam_head_bgd
from repro.kernels.spatial_predicate import (
    eval_spatial_leaves as ref_eval_leaves,
    spatial_stats_bgc as ref_stats, spatial_stats_rows_bgc as ref_rows,
    stage_class_slice as ref_class_slice)
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import cam_head as CH
from repro_torch.kernels import spatial_predicate as SP


def _occupancy_grid(seed, B=6, g=8, C=3, density=0.1, dead=0.3):
    """Sparse occupancy logits with whole classes knocked out per frame,
    so empty-class sentinels mix with live classes in one batch."""
    rng = np.random.default_rng(seed)
    occ = rng.random((B, g, g, C)) < density
    occ &= ~(rng.random((B, C)) < dead)[:, None, None, :]
    return np.where(occ, 5.0, -5.0).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_spatial_stats_plain_bit_exact_vs_pallas_interpreter(seed):
    gl = _occupancy_grid(seed)
    want = np.asarray(ref_stats(jnp.asarray(gl), interpret=True))
    got = SP.spatial_stats_bgc(torch.as_tensor(gl)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref.spatial_stats_ref(
        torch.as_tensor(gl)).numpy(), want)
    empty = ~(gl > 0.2).any((1, 2))
    assert empty.any() and (~empty).any()
    np.testing.assert_array_equal(got[..., 0][empty], gl.shape[1])
    np.testing.assert_array_equal(got[..., 1][empty], -1.0)
    np.testing.assert_array_equal(got[..., 4][empty], 0.0)


@pytest.mark.parametrize("tau", [0.2, 0.0, -1.5])
def test_spatial_stats_plain_bit_exact_on_noise_and_ties(tau):
    """Continuous logits (and values exactly at tau: strict >)."""
    rng = np.random.default_rng(7)
    gl = rng.normal(0, 1, (4, 8, 8, 2)).astype(np.float32)
    gl[0, 3, 3, 0] = np.float32(tau)
    want = np.asarray(ref_stats(jnp.asarray(gl), tau=tau, interpret=True))
    got = SP.spatial_stats_bgc(torch.as_tensor(gl), tau=tau).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [[4, 1, 1, 3], [0], [5, 5, 5, 2, 0, 1, 3,
                                                      4, 2, 2, 0, 5]])
def test_spatial_stats_rows_plain_bit_exact_unsorted_duplicates(rows):
    gl = _occupancy_grid(11, density=0.15)
    rows = np.asarray(rows, np.int32)
    want = np.asarray(ref_rows(jnp.asarray(gl), jnp.asarray(rows),
                               interpret=True))
    got = SP.spatial_stats_rows_bgc(torch.as_tensor(gl),
                                    torch.as_tensor(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.spatial_stats_rows_inline(torch.as_tensor(gl),
                                      torch.as_tensor(rows)).numpy(), want)


@pytest.mark.parametrize("g,D,C", [(8, 16, 3), (4, 32, 2), (8, 64, 8)])
def test_cam_head_plain_vs_pallas_interpreter(g, D, C):
    rng = np.random.default_rng(g * D + C)
    feat = rng.normal(0, 1, (3, g * g, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, C)) * 0.1).astype(np.float32)
    b = (rng.normal(0, 1, (C,)) * 0.1).astype(np.float32)
    rc, rcam = ref_cam_head_bgd(jnp.asarray(feat), jnp.asarray(w),
                                jnp.asarray(b), interpret=True)
    tc, tcam = CH.cam_head_bgd(torch.as_tensor(feat), torch.as_tensor(w),
                               torch.as_tensor(b))
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(rcam), rtol=1e-4,
                               atol=1e-4)
    # the (B, g, g, D) adapter and the plain reference agree too
    f4 = feat.reshape(3, g, g, D)
    oc, ocam = ops.cam_head(torch.as_tensor(f4), torch.as_tensor(w),
                            torch.as_tensor(b))
    wc, wcam = rref.cam_head_ref(jnp.asarray(f4), jnp.asarray(w),
                                 jnp.asarray(b))
    np.testing.assert_allclose(oc.numpy(), np.asarray(wc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ocam.numpy(), np.asarray(wcam), rtol=1e-4,
                               atol=1e-4)
    pc, pcam = ref.cam_head_ref(torch.as_tensor(f4), torch.as_tensor(w),
                                torch.as_tensor(b))
    np.testing.assert_allclose(pcam.numpy(), np.asarray(wcam), rtol=1e-4,
                               atol=1e-4)


def test_eval_spatial_leaves_and_class_slice_identical():
    rng = np.random.default_rng(3)
    B, g, C = 5, 8, 4
    gl = rng.normal(0, 1, (B, g, g, C)).astype(np.float32)
    L = 40
    a = rng.integers(0, C, L).astype(np.int32)
    b = rng.integers(0, C, L).astype(np.int32)
    use_row = rng.random(L) < 0.5
    radius = rng.integers(0, 3, L).astype(np.int32)
    rstats = rops.spatial_stats(jnp.asarray(gl))
    want = np.asarray(ref_eval_leaves(rstats, jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(use_row),
                                      jnp.asarray(radius), grid=g))
    tstats = ops.spatial_stats_inline(torch.as_tensor(gl))
    got = SP.eval_spatial_leaves(tstats, torch.as_tensor(a),
                                 torch.as_tensor(b),
                                 torch.as_tensor(use_row),
                                 torch.as_tensor(radius), grid=g).numpy()
    np.testing.assert_array_equal(got, want)
    for x, y in zip(SP.stage_class_slice(a[:7], b[:7]),
                    ref_class_slice(a[:7], b[:7])):
        np.testing.assert_array_equal(x, y)


def test_cpu_dispatch_never_launches_and_other_devices_raise():
    build.reset_launches()
    gl = torch.as_tensor(_occupancy_grid(0))
    ops.spatial_stats_inline(gl)
    ops.spatial_stats_rows_inline(gl, torch.tensor([1, 0]))
    ops.cam_head(torch.zeros(2, 4, 4, 8), torch.zeros(8, 3), torch.zeros(3))
    assert ops.launch_counts() == {k: 0 for k in build.LAUNCHES}
    meta = torch.empty((2, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        SP.spatial_stats_bgc(meta)
    with pytest.raises(ValueError):
        CH.cam_head_bgd(torch.empty((2, 16, 8), device="meta"),
                        torch.empty((8, 3), device="meta"),
                        torch.empty((3,), device="meta"))
