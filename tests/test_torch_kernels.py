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
from repro_torch.kernels import decode_attention as DA
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
# reference there)
DECODE_CASES = [(S, klen, dt) for S, klen in [(256, 256), (256, 100),
                                              (512, 1), (300, 300),
                                              (300, 77)]
                for dt in ("float32", "bfloat16")]


@pytest.mark.parametrize("S,klen,dt", DECODE_CASES)
def test_decode_attention_plain_vs_pallas_interpreter(S, klen, dt):
    """The port's ``ops.decode_attention`` (its plain version on a CPU
    tensor) against JAX's wrapper, which interprets the Pallas kernel:
    1e-4 in float32, 2e-2 in bfloat16, as tests/test_kernels.py holds it."""
    B, H, KV, hd = 2, 8, 2, 64
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


@pytest.mark.parametrize("G,hd,dt", [(7, 64, "bfloat16"), (1, 128, "float32"),
                                     (16, 64, "float32")])
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
    k = torch.zeros(2, 300, 2, 64)
    assert DA.cache_strides(k[:1].transpose(1, 2)) == (0, 64, 128)
    with pytest.raises(ValueError, match="in place"):
        DA.cache_strides(k.transpose(1, 3))        # last dim not contiguous
    with pytest.raises(ValueError, match="in place"):
        DA.cache_strides(k[..., 1:].transpose(1, 2)[..., :60])  # misaligned


def test_cpu_dispatch_never_launches_and_other_devices_raise():
    build.reset_launches()
    gl = torch.as_tensor(_occupancy_grid(0))
    ops.spatial_stats_inline(gl)
    ops.spatial_stats_rows_inline(gl, torch.tensor([1, 0]))
    ops.cam_head(torch.zeros(2, 4, 4, 8), torch.zeros(8, 3), torch.zeros(3))
    ops.flash_attention(torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32),
                        torch.zeros(1, 8, 2, 32))
    ops.decode_attention(torch.zeros(1, 4, 64), torch.zeros(1, 8, 2, 64),
                         torch.zeros(1, 8, 2, 64), 3)
    ops.rwkv6_scan(*(torch.zeros(1, 2, 3, 16) for _ in range(4)),
                   torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))
    assert ops.launch_counts() == {k: 0 for k in build.LAUNCHES}
    meta = torch.empty((2, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        SP.spatial_stats_bgc(meta)
    with pytest.raises(ValueError):
        CH.cam_head_bgd(torch.empty((2, 16, 8), device="meta"),
                        torch.empty((8, 3), device="meta"),
                        torch.empty((3,), device="meta"))
