"""Port kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run in the Pallas interpreter on the CPU.

On a CPU tensor each wrapper runs its plain version; the spatial stats
are held bit-exact (integer extrema and counts in float32), the CAM head
at 1e-4.  The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_cuda.py.
"""
import functools

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
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import spatial_predicate as SP
from torch_parity import bf16, tc_step, tf32


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


@pytest.mark.parametrize("seed,tau", [(0, 0.2), (1, 0.2), (2, 0.0),
                                      (3, -1.5)])
def test_ops_spatial_stats_bit_exact_vs_jax_entry_point(seed, tau):
    """``ops.spatial_stats`` against the JAX package's ``ops.spatial_stats``
    (its jitted entry point, interpreted on the CPU) on continuous logits
    with a value exactly at tau, at its default tau and given ones."""
    rng = np.random.default_rng(seed)
    gl = (rng.normal(0, 1, (3, 16, 16, 4)) * 3).astype(np.float32)
    gl[0, 5, 5, seed % 4] = np.float32(tau)
    kw = {} if tau == 0.2 else {"tau": tau}
    want = np.asarray(rops.spatial_stats(jnp.asarray(gl), **kw))
    before = ops.plain_counts()["spatial_stats_bgc"]
    got = ops.spatial_stats(torch.as_tensor(gl), **kw)
    assert got.shape == (3, 4, 5) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.plain_counts()["spatial_stats_bgc"] == before + 1


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


def _class_set(seed):
    """A seeded, unsorted class set of a C in 3..5 (one class in some)."""
    rng = np.random.default_rng(100 + seed)
    C = 3 + seed % 3
    return C, rng.permutation(C)[:int(rng.integers(1, C + 1))]


# seeded sets (seeds 0-5), and fixed ones: single classes, unsorted sets
CLASS_SETS = ([_class_set(seed) for seed in range(6)]
              + [(3, np.array([2])), (5, np.array([0])),
                 (5, np.array([4, 1, 3])), (4, np.array([3, 0, 2, 1]))])


@pytest.mark.parametrize("g", [8, 16])
@pytest.mark.parametrize("C,classes", CLASS_SETS, ids=str)
def test_spatial_stats_classes_bit_exact_vs_pallas_interpreter(C, classes,
                                                               g):
    """``classes=`` (the plain body on the CPU) equals the JAX kernels on
    the gathered planes ``grid[..., classes]``, full batch and row list,
    with int32 and int64 class ids."""
    gl = _occupancy_grid(int(classes.sum()) + g, B=6, g=g, C=C,
                         density=0.12)
    sl = jnp.asarray(gl[..., classes])
    want = np.asarray(ref_stats(sl, interpret=True))
    rows = np.array([5, 0, 3, 3, 1], np.int32)
    want_rows = np.asarray(ref_rows(sl, jnp.asarray(rows), interpret=True))
    for ids in (torch.as_tensor(classes), torch.as_tensor(classes).int()):
        got = SP.spatial_stats_bgc(torch.as_tensor(gl), classes=ids).numpy()
        np.testing.assert_array_equal(got, want)
        got = SP.spatial_stats_rows_bgc(torch.as_tensor(gl),
                                        torch.as_tensor(rows),
                                        classes=ids).numpy()
        np.testing.assert_array_equal(got, want_rows)
        np.testing.assert_array_equal(
            ops.spatial_stats_inline(torch.as_tensor(gl),
                                     classes=ids).numpy(), want)


@pytest.mark.parametrize("rows_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_spatial_stats_16_bit_grids_bit_exact_vs_pallas_interpreter(
        dtype, rows_kernel):
    """bfloat16 and float16 grids are widened before the compare, as the
    TPU kernel's ``astype`` does: both get the same bits in the same
    type (values near tau included, so rounding moves some across it)."""
    rng = np.random.default_rng(17)
    gl = rng.normal(0.2, 0.05, (5, 12, 12, 4)).astype(np.float32)
    gl[rng.random(gl.shape) < 0.5] = -1.0
    # just above and just below tau: float16 rounds the first under it,
    # bfloat16 the second over it
    gl[0, 0, :3, 0] = 0.2 + 1e-5
    gl[1, 5, :3, 1] = 0.2 - 1e-5
    t = torch.as_tensor(gl).to(getattr(torch, dtype))
    j = jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
    assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                          t.float().numpy())
    if rows_kernel:
        rows = np.array([1, 4, 4, 0], np.int32)
        want = ref_rows(j, jnp.asarray(rows), interpret=True)
        got = SP.spatial_stats_rows_bgc(t, torch.as_tensor(rows))
    else:
        want = ref_stats(j, interpret=True)
        got = SP.spatial_stats_bgc(t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # some cell flips across tau on rounding: the test sees the type
    assert not np.array_equal(
        got.numpy(), SP.spatial_stats_plain(torch.as_tensor(gl)).numpy()
        if not rows_kernel else
        SP.spatial_stats_rows_plain(torch.as_tensor(gl),
                                    torch.as_tensor(rows)).numpy())


@pytest.mark.parametrize("rows", [[4, 1, 1, 3], [0], [5, 5, 2, 0, 1, 3]])
def test_spatial_stats_rows_int32_and_int64_ids_agree(rows):
    gl = torch.as_tensor(_occupancy_grid(23, density=0.15))
    r64 = torch.tensor(rows, dtype=torch.int64)
    got64 = SP.spatial_stats_rows_bgc(gl, r64)
    got32 = SP.spatial_stats_rows_bgc(gl, r64.int())
    assert torch.equal(got64, got32)
    want = np.asarray(ref_rows(jnp.asarray(gl.numpy()),
                               jnp.asarray(np.asarray(rows, np.int32)),
                               interpret=True))
    np.testing.assert_array_equal(got32.numpy(), want)
    cls = torch.tensor([2, 0])
    assert torch.equal(SP.spatial_stats_rows_bgc(gl, r64, classes=cls),
                       SP.spatial_stats_rows_bgc(gl, r64.int(),
                                                 classes=cls.int()))


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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cam_head_many_classes_vs_jax_entry_point(dt):
    """``ops.cam_head`` at C 100 (past the 64 classes the card's counts
    kernel once took) in float32 and on bf16 features, weights and bias,
    against JAX's ``ops.cam_head``, which interprets the Pallas kernel
    (both widen to float32 and return float32), at 1e-4."""
    rng = np.random.default_rng(100)
    feat = rng.normal(0, 1, (2, 8, 8, 48)).astype(np.float32)
    w = (rng.normal(0, 1, (48, 100)) * 0.1).astype(np.float32)
    b = (rng.normal(0, 1, (100,)) * 0.1).astype(np.float32)
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    rc, rcam = rops.cam_head(*(jnp.asarray(a, jdt) for a in (feat, w, b)))
    tc, tcam = ops.cam_head(*(torch.as_tensor(a).to(tdt)
                              for a in (feat, w, b)))
    assert tc.dtype == tcam.dtype == torch.float32
    assert tcam.shape == (2, 8, 8, 100) and tc.shape == (2, 100)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(rcam), rtol=1e-4,
                               atol=1e-4)


def _class_block(C):
    """The MMA body's class block: C rounded up to 8, 16, 32, 64 or 128."""
    return next(n for n in (8, 16, 32, 64, 128) if C <= n or n == 128)


def _emulate_cam_mma(feat, w, b, feat_bf16, w_bf16):
    """numpy in the order of arithmetic of csrc/cam_head.cu's MMA body, on
    the model of the tensor cores' truncating sums (``tc_step``), for
    float32 arrays holding values of the inputs' types: w^T split into
    planes (TF32 hi and lo by integer round-to-nearest for float32
    features, lo zero for a bf16 w; for bf16 features a bf16 w or three
    bf16 terms of a float32 w) over class blocks of N; float32 features
    split the same way; each K-chunk (32 float32 or 64 bf16 features) a
    chain of k-steps from zero (lo w_hi, hi w_lo, hi w_hi; or the planes,
    small first), added to the sums with float32 adds; per 128-cell tile
    (zeros past P) the column sums in the body's order (a thread's rows g
    and g + 8, the xor butterfly over a warp's 8 row groups, the 8 warps
    in order); the counts kernel's tile-order sum, / P + b, relu."""
    B, P, D = feat.shape
    C = w.shape[1]
    N = _class_block(C)
    n_cb = -(-C // N)
    cols, step = (64, 16) if feat_bf16 else (32, 8)
    Dp = -(-D // cols) * cols
    n_tiles = -(-P // 128)
    wt = np.zeros((n_cb * N, Dp), np.float32)
    wt[:C, :D] = w.T
    if feat_bf16:
        w1 = bf16(wt)
        w2 = bf16(wt - w1)
        planes = [w1] if w_bf16 else [w1, w2, bf16(wt - w1 - w2)]
    else:
        w_hi = tf32(wt)
        w_lo = tf32(wt - w_hi)
    cam = np.zeros((B, P, C), np.float32)
    part = np.zeros((B, n_tiles, C), np.float32)
    for bi in range(B):
        f = np.zeros((n_tiles * 128, Dp), np.float32)
        f[:P, :D] = feat[bi]
        hi = tf32(f)
        lo = tf32(f - hi)
        for cb in range(n_cb):
            cls = slice(cb * N, cb * N + N)
            tot = np.zeros((len(f), N), np.float32)
            for c0 in range(0, Dp, cols):
                acc = np.zeros_like(tot)
                for k0 in range(c0, c0 + cols, step):
                    ks = slice(k0, k0 + step)
                    if feat_bf16:
                        for pl in planes[::-1]:
                            acc = tc_step(acc, f[:, ks], pl[cls, ks])
                    else:
                        acc = tc_step(acc, lo[:, ks], w_hi[cls, ks])
                        if not w_bf16:
                            acc = tc_step(acc, hi[:, ks], w_lo[cls, ks])
                        acc = tc_step(acc, hi[:, ks], w_hi[cls, ks])
                tot = tot + acc
            u = tot.reshape(n_tiles, 8, 2, 8, N)   # tile, warp, +8, g, class
            u = u[:, :, 0] + u[:, :, 1]
            u = u[:, :, 0::2] + u[:, :, 1::2]      # lanes xor 4
            u = u[:, :, 0::2] + u[:, :, 1::2]      # xor 8
            u = u[:, :, 0] + u[:, :, 1]            # xor 16
            col = np.zeros((n_tiles, N), np.float32)
            for i in range(8):
                col = col + u[:, i]
            n = min(N, C - cb * N)
            cam[bi, :, cb * N:cb * N + n] = tot[:P, :n]
            part[bi, :, cb * N:cb * N + n] = col[:, :n]
    s = np.zeros((B, C), np.float32)
    for t in range(n_tiles):
        s = s + part[:, t]
    return np.maximum(s / np.float32(P) + b, np.float32(0)), cam


@pytest.mark.parametrize("C", [8, 100])
@pytest.mark.parametrize("types", ["float32", "bf16 feat w b", "bf16 feat",
                                   "bf16 w"])
def test_cam_head_mma_order_vs_pallas_interpreter(C, types):
    """The MMA body's order of arithmetic (``_emulate_cam_mma``: the TF32
    split by integer round-to-nearest or the bf16 planes, K-chunks of
    their own added in float32, the column sums in its tile order and the
    counts in tile order) against JAX's ``cam_head_bgd(..., interpret=
    True)``, float32 out, at rtol 1e-4 / atol 1e-4: 200 cells (a ragged
    second 128-cell tile), 96 features (a ragged K-chunk of 64 on bf16
    features), C 8 (one class block) and 100 (one of 128, classes past
    C dropped), for each mix of feature and weight types (a float32 w on
    bf16 features is three bf16 planes, a bf16 w on float32 features one
    TF32 plane)."""
    rng = np.random.default_rng(C + len(types))
    feat = rng.normal(0, 1, (2, 200, 96)).astype(np.float32)
    w = (rng.normal(0, 1, (96, C)) * 0.1).astype(np.float32)
    b = (rng.normal(0, 1, (C,)) * 0.1).astype(np.float32)
    on = {n: n in types.split() for n in ("feat", "w", "b")}
    feat, w, b = (bf16(a) if on[n] else a
                  for n, a in (("feat", feat), ("w", w), ("b", b)))
    jt = {n: jnp.bfloat16 if on[n] else jnp.float32 for n in on}
    rc, rcam = ref_cam_head_bgd(jnp.asarray(feat, jt["feat"]),
                                jnp.asarray(w, jt["w"]),
                                jnp.asarray(b, jt["b"]), interpret=True)
    counts, cam = _emulate_cam_mma(feat, w, b, on["feat"], on["w"])
    np.testing.assert_allclose(cam, np.asarray(rcam), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(counts, np.asarray(rc), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("C,D,dtype,offset,want", [
    (3, 256, torch.float32, 0, "stream"),        # the filter's OD head
    (128, 256, torch.float32, 0, "mma"),
    (128, 256, torch.bfloat16, 0, "mma"),
    (300, 64, torch.bfloat16, 0, "mma"),
    (128, 30, torch.float32, 0, "stream"),       # rows of 120 bytes
    (128, 36, torch.float32, 0, "mma"),          # rows of 144 bytes
    (128, 36, torch.bfloat16, 0, "stream"),      # rows of 72 bytes
    (128, 256, torch.float32, 4, "stream"),      # 4 bytes off 16
    (128, 256, torch.bfloat16, 8, "stream")])
def test_cam_head_body_for_routing(C, D, dtype, offset, want):
    """``body_for``: the MMA body from ``CAM_MMA_MIN_CLASSES`` classes on
    where TMA can read the features (rows a multiple of 16 bytes, a
    16-byte aligned start), the streaming body for the filter's three
    classes and everything else; the crossover itself on both sides."""
    assert CH.body_for(C, D, dtype, 1024 + offset) == want
    n = CH.CAM_MMA_MIN_CLASSES
    assert CH.body_for(n - 1, 256, dtype, 1024) == "stream"
    assert CH.body_for(n, 256, dtype, 1024) == "mma"
    assert CH.CELL_TILE == {"stream": 64, "mma": 128}


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


# the JAX decode test's six cases (S, kv_len) x dtype, and a ragged S = 300
# that the JAX wrapper's 256-key blocks do not divide (it falls back to its
# reference there), at hd 64 over two kv heads; then hd 256, paligemma's
# group (G 8 over one kv head), at kv_len 1, 100 and S
DECODE_CASES = (
    [pytest.param(S, klen, dt, 64, id=f"{S}-{klen}-{dt}")
     for S, klen in [(256, 256), (256, 100), (512, 1), (300, 300), (300, 77)]
     for dt in ("float32", "bfloat16")]
    + [pytest.param(S, klen, dt, 256, id=f"hd256-{S}-{klen}-{dt}")
       for S in (256, 512) for klen in (1, 100, S)
       for dt in ("float32", "bfloat16")])


# (hd, G, dtype): head dims and groups that run the card's padded bodies
# (hd 16 is every zoo smoke config's; 20 has rows no 16-byte copy fits),
# chunks of 16 query heads (G 20) and the slab body (hd 320)
ANY_SHAPE_CASES = [(hd, G, dt) for hd, G in [(16, 7), (16, 20), (20, 20),
                                             (96, 20), (320, 4), (320, 20)]
                   for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("hd,G,dt", ANY_SHAPE_CASES, ids=str)
def test_decode_attention_any_shape_vs_pallas_interpreter(hd, G, dt):
    """``ops.decode_attention`` (the plain version on a CPU tensor) at
    head dims and group sizes that the card runs on padded, chunked or
    slab bodies, against JAX's wrapper interpreting the Pallas kernel (S
    256, one of its blocks) at kv_len 77 and S: 1e-4 in float32, 2e-2 in
    bfloat16, as ``DECODE_CASES``."""
    B, KV, S = 2, 2, 256
    rng = np.random.default_rng(hd + G)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jdt, tdt = getattr(jnp, dt), getattr(torch, dt)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in (q, k, v))
    for klen in (77, S):
        want = rops.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                     jnp.int32(klen))
        got = ops.decode_attention(tq, tk, tv, klen)
        assert got.dtype == tdt and got.shape == (B, KV * G, hd)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            atol=1e-4 if dt == "float32" else 2e-2)


# (hd, dtype, G, aligned) -> (width, chunks, slabs, rows): the least body
# at or above hd up to 256, chunks of 16 query heads (bf16 at widths 64
# and 128 beyond 16 heads: the rows body's 32, 64 or 128 a block), the slab
# body above 256 or for rows no 16-byte copy or tensor map can read
BODY_CASES = [(1, "bfloat16", 1, True, (64, 1, 1, 16)),
              (16, "bfloat16", 7, True, (64, 1, 1, 16)),
              (16, "float32", 7, True, (64, 1, 1, 16)),
              (64, "bfloat16", 16, True, (64, 1, 1, 16)),
              (65, "bfloat16", 17, True, (128, 1, 1, 32)),
              (65, "float32", 17, True, (128, 2, 1, 16)),
              (128, "bfloat16", 32, True, (128, 1, 1, 32)),
              (64, "bfloat16", 71, True, (64, 1, 1, 128)),
              (64, "bfloat16", 200, True, (64, 2, 1, 128)),
              (48, "bfloat16", 40, True, (64, 1, 1, 64)),
              (129, "float32", 8, True, (256, 1, 1, 16)),
              (256, "bfloat16", 71, True, (256, 5, 1, 16)),
              (257, "float32", 1, True, (0, 1, 3, 16)),
              (320, "bfloat16", 20, True, (0, 2, 3, 16)),
              (512, "float32", 8, True, (0, 1, 4, 16)),
              (1024, "bfloat16", 1, True, (0, 1, 8, 16)),
              (20, "bfloat16", 71, False, (0, 5, 1, 16)),
              (200, "float32", 8, False, (0, 1, 2, 16))]


@pytest.mark.parametrize("hd,dt,G,aligned,want", BODY_CASES, ids=str)
def test_decode_attention_body_for_every_shape(hd, dt, G, aligned, want):
    """``body_for`` routes every head dim and group to a body; the split
    plan's blocks and the merge scratch follow its chunks, slabs and rows
    (a pitch of min(G, rows) rows a chunk)."""
    body = DA.body_for(hd, getattr(torch, dt), G, aligned)
    assert (body.width, body.chunks, body.slabs, body.rows) == want
    assert body.name == ("slab" if want[0] == 0 else f"w{want[0]}"
                         + ("_rows" if want[3] > 16 else ""))
    assert DA.scratch_floats(2, 3, G, hd, 1, body.rows) == 0
    assert DA.scratch_floats(2, 3, G, hd, 5, body.rows) == (
        2 * 3 * body.chunks * 5 * min(G, body.rows) * (hd + 2))
    with pytest.raises(ValueError):
        DA.body_for(0, torch.float32, G)


@pytest.mark.parametrize("S,klen,dt,hd", DECODE_CASES)
def test_decode_attention_plain_vs_pallas_interpreter(S, klen, dt, hd):
    """The port's ``ops.decode_attention`` (its plain version on a CPU
    tensor) against JAX's wrapper, which interprets the Pallas kernel:
    1e-4 in float32, 2e-2 in bfloat16, as tests/test_kernels.py holds it."""
    B, H = 2, 8
    KV = 2 if hd == 64 else 1
    rng = np.random.default_rng(S + klen)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    jdt = getattr(jnp, dt)
    want = rops.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                 jnp.int32(klen))
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dt))
                  for a in (q, k, v))
    for kv_len in (klen, torch.tensor([klen], dtype=torch.int32)):
        got = ops.decode_attention(tq, tk, tv, kv_len)
        assert got.dtype == tq.dtype and got.shape == (B, H, hd)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32),
            atol=1e-4 if dt == "float32" else 2e-2)
    # the kernel layout's plain version equals the JAX reference's
    got = DA.decode_attention_bkgd(
        tq.reshape(B, KV, H // KV, hd), tk.transpose(1, 2).contiguous(),
        tv.transpose(1, 2).contiguous(), klen)
    np.testing.assert_allclose(
        got.reshape(B, H, hd).float().numpy(),
        np.asarray(rref.decode_attention_ref(
            *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.int32(klen)),
            np.float32), atol=1e-4 if dt == "float32" else 2e-2)


# (B, KV, S, SMs, resident blocks per SM, kv_len): qwen2-0.5b's
# decode_32k, small batches whose grid the splits must fill, a one-key
# cache, a kv_len of 1 in a long cache, and one just past a split boundary
SPLIT_CASES = [(128, 2, 32768, 132, 4, 30000), (128, 2, 32768, 132, 4, 32768),
               (2, 2, 512, 132, 4, 300), (1, 1, 1, 132, 4, 1),
               (4, 8, 300, 132, 2, 77), (1, 2, 100000, 132, 4, 100000),
               (1, 1, 20000, 132, 4, 1), (1, 1, 20000, 132, 4, 12345),
               (2, 2, 9000, 132, 4, 4609), (64, 8, 4096, 132, 2, 4000)]


@pytest.mark.parametrize("B,KV,S,n_sm,per_sm,kv_len", SPLIT_CASES)
def test_decode_attention_splits_cover_the_cache(B, KV, S, n_sm, per_sm,
                                                 kv_len):
    """The host's split count fills whole waves of resident blocks (or is
    the best-filled count), and the spans the kernel derives from kv_len
    cover [0, kv_len) in order, in whole tiles, no live span shorter than
    another but the last."""
    nsplit = DA.split_count(B, KV, S, n_sm, per_sm)
    assert 1 <= nsplit <= min(-(-S // DA.TILE), DA.MAX_SPLITS)

    def fill(n):
        blocks = B * KV * n
        slots = n_sm * per_sm
        return blocks / (-(-blocks // slots) * slots)

    cap = min(-(-S // DA.TILE), DA.MAX_SPLITS)
    assert fill(nsplit) >= DA.WAVE_FILL or fill(nsplit) == max(
        fill(n) for n in range(1, cap + 1))
    spans = [DA.split_span(kv_len, nsplit, i) for i in range(nsplit)]
    assert spans[0][0] == 0 and spans[-1][1] == kv_len
    assert all(lo2 == hi for (_, hi), (lo2, _) in zip(spans, spans[1:]))
    n_live = sum(1 for lo, hi in spans if hi > lo)
    live, empty = spans[:n_live], spans[n_live:]
    assert n_live >= 1 and all(hi == lo for lo, hi in empty)
    assert all(lo % DA.TILE == 0 for lo, _ in live)
    full = {hi - lo for lo, hi in live[:-1]}
    assert len(full) <= 1 and all(n % DA.TILE == 0 for n in full)
    assert 0 < live[-1][1] - live[-1][0] <= max(full | {kv_len})
    with pytest.raises(ValueError, match="kv_len"):
        DA.decode_attention_bkgd(torch.zeros(1, 1, 1, 64),
                                 torch.zeros(1, 1, 8, 64),
                                 torch.zeros(1, 1, 8, 64), 9)


def _merge_live(kv_len, nsplit):
    """The splits the merge kernel reads for a (b, kv head): its ``live``,
    from kv_len on the device as the kernel derives it."""
    tiles = -(-kv_len // DA.TILE)
    per = -(-tiles // nsplit)
    return -(-tiles // per) if per else 0


# (B, KV, S, SMs, kv_len) of the bf16 hd 256 body, one block an SM:
# SPLIT_CASES' shapes, then B KV below, at and above the 132 SMs at kv_len
# 1, one tile, one key past it, 4097 (one key in its last tile) and S
HD256_SPLIT_CASES = [(B, KV, S, n_sm, kv_len)
                     for B, KV, S, n_sm, _, kv_len in SPLIT_CASES] + [
    (B, KV, 4200, 132, klen) for B, KV in [(1, 1), (8, 1), (128, 1),
                                           (131, 1), (66, 2), (133, 1),
                                           (132, 2), (75, 4)]
    for klen in (1, 64, 65, 4097, 4200)]


@pytest.mark.parametrize("B,KV,S,n_sm,kv_len", HD256_SPLIT_CASES)
def test_decode_attention_hd256_splits_cover_the_cache(B, KV, S, n_sm,
                                                       kv_len):
    """The bf16 hd 256 body's grid (nsplit, KV, B) at one block an SM: one
    split a (b, kv head) where the pairs fill ``WAVE_FILL`` of the SMs
    (no merge), else the split count that fills the waves best; each
    pair's splits cover [0, kv_len) once, in tile order; the merge reads
    as many splits as hold keys; each split's (acc, m, l) lies within the
    wrapper's scratch, which is none for one split."""
    G, hd = 8, 256
    nsplit = DA.split_count(B, KV, S, n_sm, 1)
    if DA.WAVE_FILL * n_sm <= B * KV <= n_sm:
        assert nsplit == 1
    spans = [DA.split_span(kv_len, nsplit, i) for i in range(nsplit)]
    keys = [key for lo, hi in spans for key in range(lo, hi)]
    assert keys == list(range(kv_len))
    assert all(lo % DA.TILE == 0 for lo, hi in spans if hi > lo)
    live = [i for i, (lo, hi) in enumerate(spans) if hi > lo]
    assert live == list(range(_merge_live(kv_len, nsplit)))
    floats = DA.scratch_floats(B, KV, G, hd, nsplit)
    assert (floats == 0) == (nsplit == 1)
    pitch = G * (hd + 2)
    if nsplit > 1:
        last = (B * KV - 1) * nsplit + live[-1]    # the highest part row
        assert (last + 1) * pitch <= floats


F32_STAGE = 32                 # keys a stage of the float32 hd 256 body
F32_CONSUMERS = 4              # its consumer warps, 256 / 4 columns each
NEG_INF = np.float32(-0.7 * 3.4028234663852886e38)


def _emulate_hd256_f32(q, k, v, kv_len, n_sm=132):
    """numpy float32 in the float32 hd 256 body's order of arithmetic: the
    split plan at one block an SM, 32-key stages, each consumer warp's
    partial scores over its own columns summed column by column, the
    warps' partials summed in warp order, then scaled and masked; the
    online softmax shared by every warp; acc += p v key by key; each
    split's (m, l, acc), then the merge's (splits in order) or o =
    acc / max(l, 1e-30).  q (B, KV, G, hd), k and v (B, KV, S, hd)."""
    B, KV, G, hd = q.shape
    S = k.shape[2]
    W, cols = F32_CONSUMERS, hd // F32_CONSUMERS
    scale = np.float32(1.0 / np.sqrt(hd))
    nsplit = DA.split_count(B, KV, S, n_sm, 1)
    qw = q.reshape(B, KV, G, W, cols).transpose(0, 1, 3, 2, 4)
    states = []
    for split in range(nsplit):
        lo, hi = DA.split_span(kv_len, nsplit, split)
        if lo >= hi:
            continue
        m = np.full((B, KV, G), NEG_INF, np.float32)
        lsum = np.zeros((B, KV, G), np.float32)
        acc = np.zeros((B, KV, G, hd), np.float32)
        for key0 in range(lo, hi, F32_STAGE):
            nv = min(F32_STAGE, hi - key0)
            kw = k[:, :, key0:key0 + nv].reshape(B, KV, nv, W, cols
                                                 ).transpose(0, 1, 3, 2, 4)
            part = np.zeros((B, KV, W, G, nv), np.float32)
            for c in range(cols):        # (B, KV, W, G, 1) x (.., 1, nv)
                part += qw[..., None, c] * kw[:, :, :, None, :, c]
            s = part[:, :, 0]
            for w in range(1, W):
                s = s + part[:, :, w]
            s = s * scale
            mx = np.maximum(m, s.max(-1))
            corr = np.exp(m - mx)
            p = np.exp(s - mx[..., None])
            lsum = lsum * corr + p.sum(-1, dtype=np.float32)
            m = mx
            acc = acc * corr[..., None]
            for j in range(nv):
                acc = acc + p[..., j, None] * v[:, :, None, key0 + j]
        states.append((m, lsum, acc))
    if nsplit == 1:
        m, lsum, acc = states[0]
        return acc / np.maximum(lsum, np.float32(1e-30))[..., None]
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = np.maximum(mx, m)
    lt = np.zeros_like(mx)
    at = np.zeros_like(states[0][2])
    for m, lsum, acc in states:
        f = np.exp(m - mx)
        lt = lt + lsum * f
        at = at + acc * f[..., None]
    return at / np.maximum(lt, np.float32(1e-30))[..., None]


@pytest.mark.parametrize("G", [1, 8, 16])
@pytest.mark.parametrize("klen", [1, 65, 330, 3001])
def test_decode_attention_hd256_f32_order_vs_pallas_interpreter(G, klen):
    """The float32 hd 256 body's order of arithmetic (``_emulate_hd256_f32``:
    the split plan, 32-key stages, column-box partial scores summed in warp
    order, the shared softmax, the merge) against JAX's wrapper, which
    interprets the Pallas kernel, at 1e-4.  A 3,072-row cache at kv_len
    3001 makes 47 one-tile splits of one (b, kv head) and a merge, B 2 at
    330 six splits of a 512-row cache."""
    B, KV, hd = (1, 1, 256) if klen > 512 else (2, 1, 256)
    S = 3072 if klen > 512 else 512
    rng = np.random.default_rng(klen + G)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = np.asarray(rops.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.int32(klen)))
    k[:, klen:] = np.nan                 # rows past kv_len are never read
    v[:, klen:] = np.nan
    got = _emulate_hd256_f32(q.reshape(B, KV, G, hd), k.transpose(0, 2, 1, 3),
                             v.transpose(0, 2, 1, 3), klen)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.reshape(B, KV * G, hd), want, rtol=0,
                               atol=1e-4)


SLAB_STAGE, SLAB_COLS, SLAB_WARPS = 32, 128, 4   # the slab body's geometry


def _emulate_slab_f32(q, k, v, kv_len, n_sm=132, per_sm=3):
    """numpy float32 in the float32 slab body's order of arithmetic (hd
    above 256): the split plan over B KV chunks slabs blocks at ``per_sm``
    blocks an SM; 32-key stages; each warp's partial scores over its 32
    columns of every 128-column chunk, column by column and chunk by
    chunk, the four warps' partials summed in warp order, then scaled and
    masked; the online softmax; acc += p v key by key; each split's (m, l,
    acc), then the merge's (splits in order) or o = acc / max(l, 1e-30).
    Every slab of a row computes these same scores, so one emulation
    stands for all.  q (B, KV, G, hd), k and v (B, KV, S, hd)."""
    B, KV, G, hd = q.shape
    S = k.shape[2]
    body = DA.body_for(hd, torch.float32, G)
    nsplit = DA.split_count(B, KV * body.chunks * body.slabs, S, n_sm, per_sm)
    scale = np.float32(1.0 / np.sqrt(hd))
    wc = SLAB_COLS // SLAB_WARPS
    states = []
    for split in range(nsplit):
        lo, hi = DA.split_span(kv_len, nsplit, split)
        if lo >= hi:
            continue
        m = np.full((B, KV, G), NEG_INF, np.float32)
        lsum = np.zeros((B, KV, G), np.float32)
        acc = np.zeros((B, KV, G, hd), np.float32)
        for key0 in range(lo, hi, SLAB_STAGE):
            nv = min(SLAB_STAGE, hi - key0)
            kk = k[:, :, key0:key0 + nv]
            part = np.zeros((SLAB_WARPS, B, KV, G, nv), np.float32)
            for c0 in range(0, hd, SLAB_COLS):
                for w in range(SLAB_WARPS):
                    for c in range(c0 + w * wc, min(c0 + (w + 1) * wc, hd)):
                        part[w] += q[..., c, None] * kk[:, :, None, :, c]
            s = part[0]
            for w in range(1, SLAB_WARPS):
                s = s + part[w]
            s = s * scale
            mx = np.maximum(m, s.max(-1))
            corr = np.exp(m - mx)
            p = np.exp(s - mx[..., None])
            lsum = lsum * corr + p.sum(-1, dtype=np.float32)
            m = mx
            acc = acc * corr[..., None]
            for j in range(nv):
                acc = acc + p[..., j, None] * v[:, :, None, key0 + j]
        states.append((m, lsum, acc))
    if nsplit == 1:
        m, lsum, acc = states[0]
        return acc / np.maximum(lsum, np.float32(1e-30))[..., None]
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = np.maximum(mx, m)
    lt = np.zeros_like(mx)
    at = np.zeros_like(states[0][2])
    for m, lsum, acc in states:
        f = np.exp(m - mx)
        lt = lt + lsum * f
        at = at + acc * f[..., None]
    return at / np.maximum(lt, np.float32(1e-30))[..., None]


@pytest.mark.parametrize("B,KV,G,S,klen,hd", [(2, 1, 20, 256, 77, 320),
                                              (1, 1, 1, 2048, 1500, 320),
                                              (2, 1, 8, 512, 330, 512)],
                         ids=str)
def test_decode_attention_slab_f32_order_vs_pallas_interpreter(B, KV, G, S,
                                                               klen, hd):
    """The float32 slab body's order of arithmetic (``_emulate_slab_f32``)
    against JAX's wrapper interpreting the Pallas kernel, at 1e-4: G 20
    (two chunks of query heads), one (b, kv head) cut into many splits
    and merged, and hd 512 (four slabs)."""
    rng = np.random.default_rng(hd + G + klen)
    q, k, v = (rng.normal(0, 1, shape).astype(np.float32)
               for shape in ((B, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = np.asarray(rops.decode_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.int32(klen)))
    k[:, klen:] = np.nan                 # rows past kv_len are never read
    v[:, klen:] = np.nan
    got = _emulate_slab_f32(q.reshape(B, KV, G, hd), k.transpose(0, 2, 1, 3),
                            v.transpose(0, 2, 1, 3), klen)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.reshape(B, KV * G, hd), want, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("G,hd,dt", [(7, 64, "bfloat16"), (1, 128, "float32"),
                                     (16, 64, "float32"), (7, 16, "bfloat16"),
                                     (20, 320, "float32")])
def test_decode_attention_reads_the_model_cache_in_place(G, hd, dt,
                                                         monkeypatch):
    """``ops.decode_attention`` hands the kernel wrapper (B, KV, S, hd)
    views of the model's (B, S, KV, hd) cache, never a copy; the strides
    the kernel would read them through address the same rows; and the
    plain version gives the same result from the view as from a
    contiguous copy (the kernel's bit-identity is a card test)."""
    B, KV, S, klen = 2, 2, 300, 77
    dtype = getattr(torch, dt)
    rng = np.random.default_rng(G + hd)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32))
               .to(dtype) for shape in ((B, KV * G, hd), (B, S, KV, hd),
                                        (B, S, KV, hd)))
    seen = []

    def spy(qq, kk, vv, kv_len):
        seen.append((kk, vv))
        return DA.decode_attention_bkgd(qq, kk, vv, kv_len)

    monkeypatch.setattr(ops, "decode_attention_bkgd", spy)
    got = ops.decode_attention(q, k, v, klen)
    (kk, vv), = seen
    assert kk.data_ptr() == k.data_ptr() and vv.data_ptr() == v.data_ptr()
    assert kk.shape == (B, KV, S, hd) and not kk.is_contiguous()
    assert DA.cache_strides(kk) == (S * KV * hd, hd, KV * hd)
    assert DA.cache_strides(kk.contiguous()) == (KV * S * hd, S * hd, hd)
    want = DA.decode_attention_bkgd(q.reshape(B, KV, G, hd),
                                    kk.contiguous(), vv.contiguous(), klen)
    # the CPU einsum may sum a strided operand in another order: one ulp
    torch.testing.assert_close(got, want.reshape(B, KV * G, hd), rtol=0,
                               atol=1e-6 if dt == "float32" else 0)


def test_decode_attention_cache_strides_refuse_what_the_kernel_cannot_read():
    """A last dimension that is not contiguous raises; rows off a 16-byte
    boundary are read in place too, by the slab body's narrower copies
    (``rows_aligned`` tells ``body_for``)."""
    k = torch.zeros(2, 300, 2, 64)
    ks = DA.cache_strides(k[:1].transpose(1, 2))
    assert ks == (0, 64, 128) and DA.rows_aligned(k, ks)
    with pytest.raises(ValueError, match="in place"):
        DA.cache_strides(k.transpose(1, 3))        # last dim not contiguous
    off = k[..., 1:].transpose(1, 2)[..., :60]     # misaligned rows
    ks = DA.cache_strides(off)
    assert ks == (300 * 128, 64, 128) and not DA.rows_aligned(off, ks)
    assert DA.body_for(60, torch.float32, 4,
                       DA.rows_aligned(off, ks)).width == 0
    odd = torch.zeros(2, 2, 300, 20, dtype=torch.bfloat16)   # 40-byte rows
    assert not DA.rows_aligned(odd, DA.cache_strides(odd))


def test_cpu_dispatch_never_launches_and_other_devices_raise(monkeypatch):
    """CPU and ``meta`` tensors go to the plain versions, counted by
    ``ops.plain_counts`` and never launched; a device that takes neither
    the plain version nor the kernel raises (``meta`` made such a device
    by taking it out of ``build.PLAIN_DEVICES``: no other device type can
    be made on a CPU-only build)."""
    build.reset_launches()
    ops.reset_plain_counts()
    for dev in ("cpu", "meta"):
        gl = torch.as_tensor(_occupancy_grid(0)).to(dev)
        z = functools.partial(torch.zeros, device=dev)
        ops.spatial_stats_inline(gl)
        ops.spatial_stats_rows_inline(gl, torch.tensor([1, 0], device=dev))
        ops.cam_head(z(2, 4, 4, 8), z(8, 3), z(3))
        ops.flash_attention(z(1, 8, 2, 32), z(1, 8, 2, 32), z(1, 8, 2, 32))
        out = ops.decode_attention(z(1, 4, 64), z(1, 8, 2, 64),
                                   z(1, 8, 2, 64), 3)
        assert out.device.type == dev and out.shape == (1, 4, 64)
        ops.rwkv6_scan(*(z(1, 2, 3, 16) for _ in range(4)), z(2, 16),
                       z(1, 2, 16, 16))
    assert ops.launch_counts() == {k: 0 for k in build.LAUNCHES}
    assert ops.plain_counts() == {k: 2 for k in build.LAUNCHES}
    monkeypatch.setattr(build, "PLAIN_DEVICES", ("cpu",))
    meta = torch.empty((2, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        SP.spatial_stats_bgc(meta)
    with pytest.raises(ValueError):
        CH.cam_head_bgd(torch.empty((2, 16, 8), device="meta"),
                        torch.empty((8, 3), device="meta"),
                        torch.empty((3,), device="meta"))
    m = functools.partial(torch.empty, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.decode_attention(m(1, 4, 64), m(1, 8, 2, 64), m(1, 8, 2, 64), 3)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(m(1, 8, 2, 32), m(1, 8, 2, 32), m(1, 8, 2, 32))
    with pytest.raises(ValueError, match="device"):
        ops.rwkv6_scan(*(m(1, 2, 3, 16) for _ in range(4)), m(2, 16),
                       m(1, 2, 16, 16))
