"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one (decided at run
time, in the ``cuda_device`` fixture).  They import neither jax nor the
JAX package, so on a machine without JAX they run without the suite's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Spatial stats are held bit for bit (every grid type, class list, row-id
type, and frames the host splits over clusters of 1-8 blocks); the CAM
head at 1e-4 (the same fp32 products summed in another order), with
TF32 off for matmuls and cuDNN, and bit for bit on a repeated call.  Flash and decode attention are held
at max abs err 1e-4 in float32 and 2e-2 in bfloat16 (one bf16 rounding
of outputs of magnitude ~1), as tests/test_kernels.py holds the Pallas
kernels; the float32 flash kernel's stress cases (3xTF32 tensor-core
products) at 1e-4 against the function in float64; decode attention in
bfloat16 also at four bf16 steps of its largest output where that is
smaller, since a long cache's outputs are far below 1.  The WKV scan at
the JAX kernel test's 5e-3 (and one bf16 step of its output, rtol 1e-2).
Flash attention runs at its four bodies (hd 32, 64, 128, 256) and at
head dims between them, zero-padded up to the next body; hd 320 raises.
Bf16 hd 256's wgmma body is swept over the edges of its tiles, and its
two products on one tile are held against ``torch.matmul`` at 1e-3.
Decode attention's bf16 hd 256 body is swept over the edges of its
grid, and every body ignores NaN in the cache past kv_len.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import query as Q
from repro_torch.core.filters import FilterOutputs
from repro_torch.core.plan import QueryPlan
from repro_torch.kernels import build
from repro_torch.kernels import cam_head as CH
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as RK
from repro_torch.kernels import spatial_predicate as SP
from repro_torch.models.config import BranchSpec
from repro_torch.train import filter_train as TT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _grid(seed, B=16, g=56, C=3, density=0.02):
    rng = np.random.default_rng(seed)
    occ = rng.random((B, g, g, C)) < density
    occ &= ~(rng.random((B, C)) < 0.3)[:, None, None, :]
    return np.where(occ, 1.0, rng.normal(0, 0.1, occ.shape)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_spatial_stats_kernels_bit_exact(cuda_device, seed):
    gl = torch.as_tensor(_grid(seed), device=cuda_device)
    before = dict(build.LAUNCHES)
    assert torch.equal(SP.spatial_stats_bgc(gl), SP.spatial_stats_plain(gl))
    for rows in ([9, 2, 2, 15, 0, 9], [3], list(range(15, -1, -1)) * 2):
        r = torch.tensor(rows, device=cuda_device)
        assert torch.equal(SP.spatial_stats_rows_bgc(gl, r),
                           SP.spatial_stats_rows_plain(gl, r))
        r_host = torch.tensor(rows)                 # host-side row ids
        assert torch.equal(SP.spatial_stats_rows_bgc(gl, r_host),
                           SP.spatial_stats_rows_plain(gl, r))
    assert build.LAUNCHES["spatial_stats_bgc"] == \
        before["spatial_stats_bgc"] + 1
    assert build.LAUNCHES["spatial_stats_rows_bgc"] == \
        before["spatial_stats_rows_bgc"] + 6
    with pytest.raises(IndexError):
        SP.spatial_stats_rows_bgc(gl, torch.tensor([0, 16]))


def _stats_grid(dev, seed, B, g, C, dtype="float32", density=0.02,
                flat_offset=0):
    """A (B, g, g, C) grid on the card: sparse occupied cells (1.0) over
    noise of std 0.1 (a few cells cross tau), whole classes knocked out per
    frame; ``flat_offset`` elements into a flat buffer, so an offset of 1
    starts the grid off a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = B * g * g * C
    noise = torch.randn(n + flat_offset, generator=gen, device=dev) * 0.1
    occ = torch.rand(n + flat_offset, generator=gen, device=dev) < density
    flat = torch.where(occ, torch.ones((), device=dev), noise)
    dead = torch.rand((B, 1, 1, C), generator=gen, device=dev) < 0.3
    flat[flat_offset:].view(B, g, g, C).masked_fill_(dead, -1.0)
    return flat.to(getattr(torch, dtype))[flat_offset:].view(B, g, g, C)


def _stats_equal(grid, rows=None, classes=None):
    """Kernel (one launch) and plain version agree bit for bit."""
    name = "spatial_stats_bgc" if rows is None else "spatial_stats_rows_bgc"
    before = build.LAUNCHES[name]
    if rows is None:
        got = SP.spatial_stats_bgc(grid, classes=classes)
    else:
        got = SP.spatial_stats_rows_bgc(grid, rows, classes=classes)
    if rows is None:
        want = SP.spatial_stats_plain(grid, classes=classes)
    else:
        want = SP.spatial_stats_rows_plain(grid, rows.to(grid.device),
                                           classes=classes)
    assert build.LAUNCHES[name] == before + 1
    assert got.shape == want.shape and torch.equal(got, want)


# R x g x C of the sweep, each in the three grid types
STATS_SWEEP = [(R, g, C) for R in (1, 5, 16, 32, 200) for g in (8, 56, 64)
               for C in (1, 2, 3, 8, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("R,g,C", STATS_SWEEP, ids=str)
def test_spatial_stats_sweep_bit_exact(cuda_device, R, g, C, dt):
    grid = _stats_grid(cuda_device, R * g + C, R, g, C, dt)
    gen = torch.Generator().manual_seed(R + g + C)
    _stats_equal(grid)
    cls = torch.randperm(C, generator=gen)[:max(1, C // 2 + 1)]
    _stats_equal(grid, classes=cls.to(cuda_device))
    rows = torch.randint(0, R, (max(1, R // 2),), generator=gen)
    _stats_equal(grid, rows=rows.to(cuda_device), classes=cls.to(cuda_device))
    _stats_equal(grid, rows=rows.to(cuda_device))


# every length of an unsorted class list (a repeated class too) for small
# C; for C = 1024 a few lengths up to all
CLASS_LISTS = ([(C, L) for C in (1, 2, 3, 8) for L in range(1, C + 2)]
               + [(1024, L) for L in (1, 2, 32, 33, 500, 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("C,L", CLASS_LISTS, ids=str)
def test_spatial_stats_class_lists_bit_exact(cuda_device, C, L, dt):
    grid = _stats_grid(cuda_device, C + L, 16, 56 if C < 1024 else 8, C, dt,
                       density=0.05)
    gen = torch.Generator().manual_seed(C * 7 + L)
    cls = torch.randperm(C, generator=gen)[:L]
    if L > C:                                   # a repeated class
        cls = torch.cat([cls, cls[:1]])[:L] if C > 1 else torch.zeros(
            L, dtype=torch.long)
    for ids in (cls.to(cuda_device), cls.int().to(cuda_device), cls):
        _stats_equal(grid, classes=ids)
        _stats_equal(grid, rows=torch.tensor([15, 0, 7, 7], device=ids.device),
                     classes=ids)


# unaligned spans: odd C at g = 57 (a frame of 57 * 57 * C elements is no
# multiple of 16 bytes), and grids that start off a 16-byte boundary
UNALIGNED = ([(57, C, dt, 0) for C in (1, 3, 5, 1023)
              for dt in ("float32", "bfloat16", "float16")]
             + [(56, C, dt, 1) for C in (2, 3, 8)
                for dt in ("float32", "bfloat16")])


@pytest.mark.cuda
@pytest.mark.parametrize("g,C,dt,offset", UNALIGNED, ids=str)
def test_spatial_stats_unaligned_bit_exact(cuda_device, g, C, dt, offset):
    grid = _stats_grid(cuda_device, g + C, 5 if C < 1000 else 2, g, C, dt,
                       flat_offset=offset)
    assert (grid.data_ptr() % 16 == 0) == (offset == 0)
    _stats_equal(grid)
    cls = torch.tensor([C - 1, 0], device=cuda_device)[:min(C, 2)]
    _stats_equal(grid, classes=cls)
    _stats_equal(grid, rows=torch.tensor([1, 1, 0], device=cuda_device),
                 classes=cls)


# (R, g, g, C, dtype) and the cluster size the host picks on an H100's 132
# SMs: more than two rounds of loads a block split a frame, into about a
# round a block on at most three quarters of the SMs
CLUSTER_SHAPES = [((1, 56, 56, 3, "float32"), 1),
                  ((40, 56, 56, 8, "float32"), 2),
                  ((32, 56, 56, 8, "float32"), 3),
                  ((16, 56, 56, 8, "float32"), 4),
                  ((2, 64, 64, 8, "bfloat16"), 4),
                  ((5, 57, 57, 3, "float32"), 5),
                  ((1, 64, 64, 12, "float32"), 6),
                  ((1, 56, 56, 16, "float16"), 7),
                  ((1, 57, 57, 5, "float32"), 8),
                  ((5, 8, 8, 1024, "float32"), 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,S", CLUSTER_SHAPES, ids=str)
def test_spatial_stats_cluster_split_bit_exact(cuda_device, shape, S):
    """Frames the host splits over a cluster of S blocks (S = 1: one block
    a frame): the distributed-shared-memory merge is exact, for the full
    grid, a class list and a reversed row list."""
    R, g, _, C, dt = shape
    grid = _stats_grid(cuda_device, S + R + C, R, g, C, dt)
    _stats_equal(grid)
    _stats_equal(grid, classes=torch.tensor([C - 1, 0], device=cuda_device))
    _stats_equal(grid, rows=torch.arange(R - 1, -1, -1, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("where", ["device", "host", "strided"])
def test_spatial_stats_row_ids_int32_int64(cuda_device, dtype, where):
    grid = _stats_grid(cuda_device, 3, 32, 56, 3)
    rows = torch.tensor([31, 2, 2, 0, 17, 31], dtype=dtype)
    if where == "device":
        rows = rows.to(cuda_device)
    elif where == "strided":
        rows = torch.stack([rows, rows], 1).to(cuda_device)[:, 1]
        assert rows.stride(0) == 2
    _stats_equal(grid, rows=rows)
    _stats_equal(grid, rows=rows, classes=torch.tensor([2, 0]).to(dtype))
    want = SP.spatial_stats_rows_bgc(grid, rows.long())
    assert torch.equal(SP.spatial_stats_rows_bgc(grid, rows), want)


@pytest.mark.cuda
def test_spatial_stats_one_launch_per_call(cuda_device):
    """Device int64 row and class ids, as the plan passes them: the call
    is one kernel on the card (no cast, check, gather or copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    grid = _stats_grid(cuda_device, 4, 32, 56, 3)
    rows = torch.tensor([3, 1, 4, 1, 5], device=cuda_device)
    cls = torch.tensor([2, 0], device=cuda_device)
    for call in (lambda: SP.spatial_stats_bgc(grid, classes=cls),
                 lambda: SP.spatial_stats_rows_bgc(grid, rows, classes=cls),
                 lambda: ops.spatial_stats_rows_inline(grid, rows,
                                                       classes=cls)):
        call()
        for _ in range(5):      # the profiler may drop a window's launches
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            if names:
                break
        assert len(names) == 1 and "spatial_stats_kernel" in names[0], \
            names


@pytest.mark.cuda
@pytest.mark.parametrize("tau", [0.2, -0.5])
def test_ops_spatial_stats_one_launch_bit_exact(cuda_device, tau):
    """The JAX package's public entry point ``ops.spatial_stats``: one
    launch of the stats kernel, equal to the plain version bit for bit."""
    grid = _stats_grid(cuda_device, 5, 32, 56, 3)
    before = dict(build.LAUNCHES)
    got = ops.spatial_stats(grid, tau=tau)
    torch.cuda.synchronize()
    assert build.LAUNCHES["spatial_stats_bgc"] == \
        before["spatial_stats_bgc"] + 1
    assert sum(build.LAUNCHES.values()) == sum(before.values()) + 1
    assert torch.equal(got, SP.spatial_stats_plain(grid, tau=tau))


FAULT_SCRIPT = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.kernels import spatial_predicate as SP
grid = torch.zeros((4, 8, 8, 3), device="cuda")
ids = torch.tensor({ids}, device="cuda", dtype=torch.{dtype})
if {rows}:
    SP.spatial_stats_rows_bgc(grid, ids)
else:
    SP.spatial_stats_bgc(grid, classes=ids)
print("launched", flush=True)
torch.cuda.synchronize()
print("no fault")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("rows,ids,dtype", [
    (True, [0, 4], "int64"), (True, [-1], "int32"),
    (False, [0, 3], "int64"), (False, [-2, 1], "int32")], ids=str)
def test_spatial_stats_device_id_out_of_range_faults(cuda_device, rows, ids,
                                                      dtype):
    """A bad device id faults the launch and surfaces at the next sync
    (in a subprocess: a device fault poisons the CUDA context)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    code = FAULT_SCRIPT.format(src=src, ids=ids, dtype=dtype, rows=rows)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert "launched" in res.stdout, res.stderr
    assert res.returncode != 0 and "no fault" not in res.stdout
    assert "CUDA error" in res.stderr or "AcceleratorError" in res.stderr, \
        res.stderr


@pytest.mark.cuda
def test_spatial_stats_refusals(cuda_device):
    grid = _stats_grid(cuda_device, 5, 4, 8, 3)
    with pytest.raises(TypeError):
        SP.spatial_stats_bgc(grid.to(torch.float64))
    with pytest.raises(TypeError):
        SP.spatial_stats_rows_bgc(grid, torch.tensor([0], dtype=torch.int16,
                                                     device=cuda_device))
    with pytest.raises(IndexError):
        SP.spatial_stats_bgc(grid, classes=torch.tensor([3]))
    with pytest.raises(ValueError):
        SP.spatial_stats_bgc(grid.transpose(1, 2))
    empty = SP.spatial_stats_bgc(grid, classes=torch.tensor(
        [], dtype=torch.long, device=cuda_device))
    assert empty.shape == (4, 0, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("P,D,C", [(3136, 256, 3), (64, 16, 8),
                                   (100, 40, 33), (9, 300, 64)])
def test_cam_head_kernel_matches_plain(cuda_device, P, D, C):
    g = torch.Generator().manual_seed(P + D + C)
    feat = torch.randn((4, P, D), generator=g).to(cuda_device)
    w = (torch.randn((D, C), generator=g) * 0.1).to(cuda_device)
    b = (torch.randn((C,), generator=g) * 0.1).to(cuda_device)
    counts, cam = CH.cam_head_bgd(feat, w, b)
    pc, pcam = CH.cam_head_plain(feat, w, b)
    torch.testing.assert_close(cam, pcam, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(counts, pc, rtol=1e-4, atol=1e-4)
    again, cam2 = CH.cam_head_bgd(feat, w, b)
    assert torch.equal(again, counts) and torch.equal(cam2, cam)


# (B, P, D, C, aligned): the edges of the kernel's (64-cell tile, frame)
# grid: one cell, a ragged last tile, D not a multiple of 4 and a feature
# array that starts off a 16-byte boundary (both take the scalar path),
# one frame and 128 frames at the filter's shape
CAM_EDGES = [(4, 1, 256, 3, True), (4, 3137, 256, 3, True),
             (4, 3136, 30, 3, True), (1, 3136, 256, 3, True),
             (128, 3136, 256, 3, True), (4, 100, 256, 5, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,P,D,C,aligned", CAM_EDGES, ids=str)
def test_cam_head_kernel_grid_edges(cuda_device, B, P, D, C, aligned):
    rng = np.random.default_rng(B + P + D + C)
    flat = torch.as_tensor(rng.normal(0, 1, B * P * D + 1).astype(
        np.float32), device=cuda_device)
    feat = (flat[:-1] if aligned else flat[1:]).view(B, P, D)
    assert (feat.data_ptr() % 16 == 0) == aligned
    w = torch.as_tensor((rng.normal(0, 1, (D, C)) * 0.1).astype(np.float32),
                        device=cuda_device)
    b = torch.as_tensor((rng.normal(0, 1, C) * 0.1).astype(np.float32),
                        device=cuda_device)
    before = build.LAUNCHES["cam_head_bgd"]
    counts, cam = CH.cam_head_bgd(feat, w, b)
    pc, pcam = CH.cam_head_plain(feat, w, b)
    assert build.LAUNCHES["cam_head_bgd"] == before + 1
    assert cam.shape == (B, P, C) and counts.shape == (B, C)
    torch.testing.assert_close(cam, pcam, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(counts, pc, rtol=1e-4, atol=1e-4)
    again, cam2 = CH.cam_head_bgd(feat, w, b)
    assert torch.equal(again, counts) and torch.equal(cam2, cam)


@pytest.mark.cuda
def test_filter_forward_kernel_head_matches_plain_head(cuda_device):
    spec = BranchSpec(layer=2, grid=16, n_classes=3, head_dim=32)
    trunk = TT.default_trunk(d_model=32, n_layers=2, grid=16)
    p = TT.init_filter_model(torch.Generator().manual_seed(1), trunk, spec,
                             24, device=cuda_device)
    e = np.random.default_rng(2).normal(0, 1, (8, 256, 24)).astype(
        np.float32)
    k = TT.filter_forward(p, trunk, spec, e, use_kernel=True)
    n = TT.filter_forward(p, trunk, spec, e, use_kernel=False)
    torch.testing.assert_close(k.counts, n.counts, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k.grid, n.grid, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["rows", "full", "auto"])
def test_staged_plan_on_card_identical_to_exhaustive(cuda_device, body):
    """The staged plan's spatial tiers run the kernels on the card and
    still equal the exhaustive plan bit for bit."""
    rng = np.random.default_rng(5)
    counts = rng.normal(1, 1.5, (32, 3)).astype(np.float32)
    counts[rng.random(32) < 0.7, 2] = 0.0         # rare class: compaction
    out = FilterOutputs(counts=torch.as_tensor(counts, device=cuda_device),
                        grid=torch.as_tensor(_grid(6, B=32, g=16),
                                             device=cuda_device))
    queries = [Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                      Q.Spatial(2, Q.Rel.LEFT, 0))),
               Q.Or((Q.Spatial(1, Q.Rel.ABOVE, 0, radius=1),
                     Q.Region(1, (0, 0, 8, 8), 2))),
               Q.Count(Q.Op.GE, 3)]
    plan = QueryPlan(queries)
    want = plan.evaluate(out)
    before = dict(build.LAUNCHES)
    for mb in (1, 8, 32):
        staged = plan.build_staged(None, min_bucket=mb, spatial_body=body)
        assert torch.equal(staged.evaluate(out), want)
    assert build.LAUNCHES["spatial_stats_bgc"] > before["spatial_stats_bgc"]


# (B, Sq, Sk, H, KV, hd, causal, sliding_window, dtype): the Pallas kernel
# test's shapes in both types and both maskings, sliding windows with
# GQA 4/2, and ragged lengths that no 64-row tile divides
FLASH_SWEEP = (
    [(B, Sq, Sk, H, KV, hd, causal, None, dt)
     for (B, Sq, Sk, H, KV, hd) in [(1, 128, 128, 4, 4, 32),
                                    (2, 256, 256, 8, 2, 64),
                                    (1, 512, 512, 4, 1, 128)]
     for dt in ("float32", "bfloat16") for causal in (True, False)]
    + [(1, 256, 256, 4, 2, 32, True, sw, "float32") for sw in (32, 128)]
    + [(2, 300, 300, 4, 2, 32, True, None, "float32"),
       (2, 300, 300, 4, 2, 32, False, None, "bfloat16"),
       (1, 300, 300, 4, 4, 64, True, 100, "float32"),
       (1, 77, 300, 4, 4, 128, False, None, "float32")]
    # hd 256 (paligemma's MQA, 8 heads over 1): both types and maskings,
    # sliding windows, GQA 4/2 and ragged lengths
    + [(1, 256, 256, 8, 1, 256, causal, None, dt)
       for dt in ("float32", "bfloat16") for causal in (True, False)]
    + [(1, 300, 300, 4, 1, 256, True, 100, "float32"),
       (2, 300, 300, 4, 2, 256, True, 64, "bfloat16"),
       (1, 77, 300, 2, 1, 256, False, None, "bfloat16"),
       (1, 300, 77, 2, 1, 256, False, None, "float32")]
    # bf16 hd 256's wgmma body (64-key tiles, 128-row blocks of two
    # 64-row warpgroups): lengths on every edge of both, causal or not;
    # Sq < Sk and Sq > Sk with B 2 and KV 2, Sk mostly no multiple of 64
    # (a tile at a head's end reads zeros, not the next head's keys), G 1
    # and 2; windows of 64 and 256 at G 1, 2 and 8
    + [(1, S, S, 8, 1, 256, causal, None, "bfloat16")
       for S in (1, 63, 64, 65, 127, 128, 129, 1000, 1024)
       for causal in (True, False)]
    + [(2, Sq, Sk, H, 2, 256, causal, None, "bfloat16")
       for (Sq, Sk) in ((1, 1000), (63, 129), (129, 65), (1000, 127),
                        (65, 1024), (300, 77))
       for (H, causal) in ((2, False), (4, True))]
    + [(2, Sq, Sk, H, KV, 256, True, sw, "bfloat16")
       for (Sq, Sk) in ((127, 127), (1000, 1000), (129, 1000))
       for (H, KV) in ((2, 2), (4, 2), (8, 1)) for sw in (64, 256)]
    + [(1, 1000, 1000, 2, 1, 256, False, 64, "bfloat16"),
       (2, 200, 1000, 4, 2, 256, False, 256, "bfloat16")])


def _qkv(case, dev, seed=0):
    B, Sq, Sk, H, KV, hd, _, _, dt = case
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, dt)
    return [torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                            device=dev).to(dtype)
            for shape in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_SWEEP, ids=str)
def test_flash_attention_kernel_matches_plain(cuda_device, case):
    causal, sw, dt = case[6:]
    q, k, v = _qkv(case, cuda_device)
    before = build.LAUNCHES["flash_attention_bhsd"]
    out = FA.flash_attention_bhsd(q, k, v, causal=causal, sliding_window=sw)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=sw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    atol = 1e-4 if dt == "float32" else 2e-2
    err = float((out.float() - want.float()).abs().max())
    assert err <= atol, err
    again = FA.flash_attention_bhsd(q, k, v, causal=causal,
                                    sliding_window=sw)
    assert torch.equal(again, out)


def _attention64(q, k, v, causal):
    """The plain version's function in float64 (one kv head per q head)."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(i >= j, s, torch.full((), -0.7 * 3.4028234663852886e38,
                                              dtype=s.dtype, device=s.device))
    return torch.softmax(s, -1) @ v


# (hd, causal, kind): inputs that stress the 3xTF32 split of the float32
# kernel: q and k scaled by 3 and by 8 (a peaky softmax, where one TF32
# pass misses float32 by ~1e-2), and values spread over four decades
FLASH_STRESS = [(hd, causal, kind) for hd in (32, 128, 256)
                for causal in (False, True)
                for kind in ("qk x3", "qk x8", "v spread")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_STRESS, ids=str)
def test_flash_attention_kernel_fp32_stress(cuda_device, case):
    """Held at max abs err 1e-4 against the function in float64.  At
    "qk x8" the scores have a standard deviation of 64, and the float32
    plain version itself is ~1e-4 from float64 (its own sums round at
    1e-5 of scores that large), so there the kernel is held against
    float64 alone; elsewhere also against the plain version at 1e-4."""
    hd, causal, kind = case
    q, k, v = _qkv((1, 1000, 1000, 4, 2, hd, causal, None, "float32"),
                   cuda_device, seed=hd + causal)
    if kind.startswith("qk"):
        f = float(kind[-1])
        q, k = q * f, k * f
    else:
        rng = np.random.default_rng(7)
        v = v * torch.as_tensor(10.0 ** rng.uniform(-3, 1, v.shape).astype(
            np.float32), device=cuda_device)
    out = FA.flash_attention_bhsd(q, k, v, causal=causal)
    err64 = float((out.double() - _attention64(q, k, v, causal)).abs().max())
    assert err64 <= 1e-4, err64
    if kind != "qk x8":
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        err = float((out - want).abs().max())
        assert err <= 1e-4, err


@pytest.mark.cuda
def test_flash_attention_dispatch_counts_and_refusals(cuda_device):
    case = (2, 300, 300, 4, 2, 32, False, None, "float32")
    q, k, v = _qkv(case, cuda_device, seed=3)
    before = build.LAUNCHES["flash_attention_bhsd"]
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=False)
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=False).transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    with pytest.raises(RuntimeError, match="backward"):
        FA.flash_attention_bhsd(q.clone().requires_grad_(), k, v)
    # hd 16 and 96 run through the kernel, zero-padded to the 32 and 128
    # bodies (the reference runs them); above 256 the kernel refuses
    for hd in (16, 96):
        q2, k2, v2 = _qkv((1, 64, 64, 2, 2, hd, True, None, "float32"),
                          cuda_device)
        out2 = FA.flash_attention_bhsd(q2, k2, v2)
        assert out2.shape == q2.shape and out2.is_contiguous()
        err = float((out2 - FA.flash_attention_plain(q2, k2, v2)).abs().max())
        assert err <= 1e-4, (hd, err)
    q3, k3, v3 = _qkv((1, 64, 64, 2, 2, 320, True, None, "float32"),
                      cuda_device)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        FA.flash_attention_bhsd(q3, k3, v3)
    with pytest.raises(TypeError):
        FA.flash_attention_bhsd(q.half(), k.half(), v.half())
    off = torch.empty(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_bhsd(off, k, v)
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 3


# (B, Sq, Sk, H, KV, hd, causal, sliding_window, dtype): head dims between
# the kernel's bodies, zero-padded up to the next (16 -> 32, 80 / 96 ->
# 128, 200 -> 256), in both types, ragged and windowed
FLASH_PADDED = [(1, 256, 256, 4, 2, 16, True, None, "bfloat16"),
                (2, 300, 300, 4, 1, 80, False, None, "float32"),
                (1, 300, 300, 4, 2, 96, True, 100, "float32"),
                (1, 256, 256, 8, 1, 96, False, None, "bfloat16"),
                (1, 77, 300, 2, 1, 200, True, None, "float32"),
                # hd 200 onto bf16 hd 256's wgmma body
                (2, 1000, 1000, 8, 1, 200, True, None, "bfloat16"),
                (2, 129, 300, 4, 2, 200, False, None, "bfloat16"),
                (1, 300, 300, 4, 2, 200, True, 64, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_PADDED, ids=str)
def test_flash_attention_padded_head_dims_match_plain(cuda_device, case):
    causal, sw, dt = case[6:]
    q, k, v = _qkv(case, cuda_device, seed=case[5])
    before = build.LAUNCHES["flash_attention_bhsd"]
    out = FA.flash_attention_bhsd(q, k, v, causal=causal, sliding_window=sw)
    want = FA.flash_attention_plain(q, k, v, causal=causal,
                                    sliding_window=sw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    atol = 1e-4 if dt == "float32" else 2e-2
    err = float((out.float() - want.float()).abs().max())
    assert err <= atol, err


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(2))
def test_flash_attention_wgmma_probe_matches_matmul(cuda_device, seed):
    """bf16 hd 256's two products on one tile, through its tensor maps
    (128-byte swizzle), shared-memory descriptors and wgmma layouts: d =
    a b^T (m64n64k16, both K-major) against ``torch.matmul`` in float32,
    and e = bf16(d) c (m64n256k16, A from registers, c MN-major) against
    the same product of the probe's own d.  Both are sums of exact bf16
    products in float32, in another order than cuBLAS's: 1e-3 against
    values up to ~60 and ~600 is a few float32 roundings of such sums,
    while one misplaced element or swizzle chunk is off by ~1 or more."""
    rng = np.random.default_rng(seed)
    a, b, c = (torch.as_tensor(rng.normal(0, 1, (64, 256)).astype(
        np.float32), device=cuda_device).bfloat16() for _ in range(3))
    before = dict(build.LAUNCHES)
    d, e = FA.wgmma_probe(a, b, c)
    torch.cuda.synchronize()
    assert build.LAUNCHES == before
    assert d.shape == (64, 64) and e.shape == (64, 256)
    torch.testing.assert_close(d, a.float() @ b.float().T, rtol=0,
                               atol=1e-3)
    torch.testing.assert_close(e, d.bfloat16().float() @ c.float(), rtol=0,
                               atol=1e-3)
    with pytest.raises(ValueError, match="64, 256"):
        FA.wgmma_probe(a[:32], b, c)


@pytest.mark.cuda
def test_filter_forward_pallas_trunk_matches_naive_trunk(cuda_device):
    g = 20                                   # 400 tokens: past 256 x 256
    spec = BranchSpec(layer=2, grid=g, n_classes=3, head_dim=32)
    naive = TT.default_trunk(d_model=128, n_layers=2, grid=g)
    pallas = dataclasses.replace(naive, attn_impl="pallas")
    p = TT.init_filter_model(torch.Generator().manual_seed(4), naive, spec,
                             24, device=cuda_device)
    e = np.random.default_rng(5).normal(0, 1, (4, g * g, 24)).astype(
        np.float32)
    before = build.LAUNCHES["flash_attention_bhsd"]
    a = TT.filter_forward(p, naive, spec, e, use_kernel=True)
    assert build.LAUNCHES["flash_attention_bhsd"] == before
    b = TT.filter_forward(p, pallas, spec, e, use_kernel=True)
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 2
    torch.testing.assert_close(b.counts, a.counts, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(b.grid, a.grid, rtol=1e-4, atol=1e-3)


# (B, H, T, K, V, dtype): decode's T = 1, one chunk, a ragged T, a long
# prompt, every K the kernel takes, a V that is not a multiple of 32
RWKV_SWEEP = (
    [(2, 3, T, K, K, dt) for T in (1, 32, 50, 1024) for K in (16, 64)
     for dt in ("float32", "bfloat16")]
    + [(1, 2, 77, 32, 32, "float32"), (1, 2, 40, 128, 128, "bfloat16"),
       (2, 2, 33, 64, 40, "float32")]
    # K = 128 over more chunks than the kernel's three pipeline stages
    + [(1, 2, 100, 128, 128, dt) for dt in ("float32", "bfloat16")])


def _scan_inputs(case, dev, seed=0, strong=False):
    """The JAX kernel test's distributions, with a non-zero u and s0;
    ``strong``: decays at the time-mix's clamp, lw in [-2, -1.9]."""
    B, H, T, K, V, dt = case
    rng = np.random.default_rng(seed)
    dtype = getattr(torch, dt)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a.astype(np.float32), device=dev).to(dtype)

    r, k = (t(rng.normal(0, 1, (B, H, T, K)), dtype) for _ in range(2))
    v = t(rng.normal(0, 1, (B, H, T, V)), dtype)
    lw = t(np.clip(-np.exp(rng.normal(0, 1, (B, H, T, K)) * 0.3), -2.0,
                   -1e-6) if not strong
           else -2.0 + 0.1 * rng.random((B, H, T, K)))
    u = t(rng.normal(0, 1, (H, K)) * 0.1)
    s0 = t(rng.normal(0, 1, (B, H, K, V)) * 0.1)
    return r, k, v, lw, u, s0


def _scan_close(out, sT, want_out, want_sT):
    """out against the plain version's (both rounded to r's dtype: one
    bf16 step, rtol 1e-2, may separate them), sT in fp32 at the JAX kernel
    test's 5e-3."""
    rtol = 0 if out.dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want_out.float(), rtol=rtol,
                               atol=5e-3)
    torch.testing.assert_close(sT, want_sT, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", RWKV_SWEEP, ids=str)
def test_rwkv6_scan_kernel_matches_plain(cuda_device, case):
    args = _scan_inputs(case, cuda_device)
    before = build.LAUNCHES["rwkv6_scan_bhtk"]
    out, sT = RK.rwkv6_scan_bhtk(*args)
    want_out, want_sT = RK.rwkv6_scan_plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rwkv6_scan_bhtk"] == before + 1
    assert out.dtype == args[0].dtype and sT.dtype == torch.float32
    _scan_close(out, sT, want_out, want_sT)
    again = RK.rwkv6_scan_bhtk(*args)
    assert torch.equal(again[0], out) and torch.equal(again[1], sT)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_scan_kernel_state_continuation(cuda_device, dt):
    r, k, v, lw, u, s0 = _scan_inputs((2, 4, 100, 64, 64, dt), cuda_device,
                                      seed=1)
    whole, whole_s = RK.rwkv6_scan_bhtk(r, k, v, lw, u, s0)
    h = 37
    o1, s1 = ops.rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                            lw[:, :, :h], u, s0)
    o2, s2 = ops.rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                            lw[:, :, h:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), whole, rtol=0,
                               atol=1e-5 if dt == "float32" else 0)
    torch.testing.assert_close(s2, whole_s, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 3, 100, 64, 64, "bfloat16"),
                                  (4, 40, 50, 64, 64, "bfloat16"),
                                  (1, 2, 70, 128, 128, "float32"),
                                  (2, 3, 33, 16, 16, "float32")], ids=str)
def test_rwkv6_scan_kernel_reads_strided_views(cuda_device, case):
    """The time-mix's layout: r, k, v, lw made as (B, T, H, K) and seen as
    (B, H, T, K); the kernel reads them in place and gives the bits of the
    contiguous call; ``ops.rwkv6_scan`` hands them on without a copy."""
    B, H, T, K, V, dt = case
    args = _scan_inputs((B, T, H, K, V, dt), cuda_device, seed=3)
    r, k, v, lw = (a.transpose(1, 2) for a in args[:4])
    u = args[4][:1].expand(H, K).contiguous() + 0.01
    s0 = torch.zeros((B, H, K, V), device=cuda_device) + 0.05
    views = (r, k, v, lw, u, s0)
    dense = tuple(a.contiguous() for a in views)
    assert not r.is_contiguous()
    got, want = RK.rwkv6_scan_bhtk(*views), RK.rwkv6_scan_bhtk(*dense)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _scan_close(*got, *RK.rwkv6_scan_plain(*dense))
    seen = []
    inner = RK.rwkv6_scan_bhtk

    def spy(*a):
        seen.append(a)
        return inner(*a)

    ops.rwkv6_scan_bhtk, keep = spy, ops.rwkv6_scan_bhtk
    try:
        ops.rwkv6_scan(*views)
    finally:
        ops.rwkv6_scan_bhtk = keep
    assert all(a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
               for a, b in zip(seen[0][:4], views[:4]))


@pytest.mark.cuda
def test_rwkv6_scan_kernel_refuses_unaligned_rows(cuda_device):
    """Rows the kernel cannot copy by 16 bytes raise, before any launch."""
    r, k, v, lw, u, s0 = _scan_inputs((1, 2, 20, 16, 16, "float32"),
                                      cuda_device)
    before = build.LAUNCHES["rwkv6_scan_bhtk"]
    wide = torch.zeros((1, 2, 20, 17), device=cuda_device)
    wide[..., 1:] = r
    with pytest.raises(ValueError, match="16-byte"):
        RK.rwkv6_scan_bhtk(wide[..., 1:], k, v, lw, u, s0)
    assert build.LAUNCHES["rwkv6_scan_bhtk"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_scan_kernel_strong_decays(cuda_device, dt):
    """Decays at the time-mix's clamp (lw near -2, exp(lw) ~ 0.14 a token)
    over many chunks, at the kernel test's tolerance."""
    args = _scan_inputs((2, 3, 300, 64, 64, dt), cuda_device, seed=4,
                        strong=True)
    _scan_close(*RK.rwkv6_scan_bhtk(*args), *RK.rwkv6_scan_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rwkv6_scan_kernel_state_continuation_k128(cuda_device, dt):
    """K = 128, halves carried through sT across a chunk boundary."""
    r, k, v, lw, u, s0 = _scan_inputs((1, 2, 90, 128, 128, dt), cuda_device,
                                      seed=5)
    whole, whole_s = RK.rwkv6_scan_bhtk(r, k, v, lw, u, s0)
    h = 41
    o1, s1 = ops.rwkv6_scan(r[:, :, :h], k[:, :, :h], v[:, :, :h],
                            lw[:, :, :h], u, s0)
    o2, s2 = ops.rwkv6_scan(r[:, :, h:], k[:, :, h:], v[:, :, h:],
                            lw[:, :, h:], u, s1)
    torch.testing.assert_close(torch.cat([o1, o2], 2), whole, rtol=0,
                               atol=1e-5 if dt == "float32" else 0)
    torch.testing.assert_close(s2, whole_s, rtol=0, atol=1e-5)


# (B, KV, G, S, kv_len, hd, dtype): the JAX decode test's cases, a ragged
# S, qwen2-0.5b's group of 7, the widest group and head, one kv_len of 1,
# and a long cache that the wrapper cuts into many splits
DECODE_SWEEP = (
    [(2, 2, 4, S, klen, 64, dt)
     for S, klen in [(256, 256), (256, 100), (512, 1), (300, 300),
                     (300, 77)]
     for dt in ("float32", "bfloat16")]
    + [(3, 2, 7, 1000, 999, 64, "bfloat16"), (1, 1, 16, 640, 333, 128,
                                              "float32"),
       (2, 2, 1, 129, 65, 128, "bfloat16")]
    + [(1, 1, 7, 20000, 12345, 64, dt) for dt in ("float32", "bfloat16")]
    # many splits (B KV = 1): kv_len of 1, one tile, one key past it, the
    # whole cache, and 4097, whose last live split holds one key
    + [(1, 1, 7, 20000, klen, 64, "bfloat16")
       for klen in (1, 64, 65, 20000, 4097)]
    # every group size the A operand pads, and hd 128 in bf16 at S >= 8192
    + [(2, 2, G, 1000, 999, 64, "bfloat16") for G in (1, 2, 7, 8, 16)]
    + [(1, 2, G, 8192, 8000, 128, "bfloat16") for G in (7, 16)]
    # hd 256 (paligemma's G 8 over one kv head, and G 1): ragged kv_len
    # and S no 64-key tile divides, both types, a long cache in many
    # splits, and the widest group
    + [(2, 1, G, 300, 177, 256, dt) for G in (1, 8)
       for dt in ("float32", "bfloat16")]
    + [(1, 1, 8, 20000, 12345, 256, "bfloat16"),
       (2, 2, 16, 1000, 999, 256, "float32"),
       (2, 2, 16, 1000, 999, 256, "bfloat16")]
    # bf16 hd 256's grid on the card's 132 SMs, one block each: B KV of 1
    # (64 splits) at kv_len 1, one tile, one key past it, 4097 and S; 8
    # pairs (15 splits); 100 pairs (5); 128 and 132 pairs (G 8 and 16), one
    # block a pair, no merge; 133 pairs (9 splits at G 8; at G 1 and kv_len
    # 1 one live split of 5); a ragged S at G 1 and 16 (6 one-tile splits);
    # a one-row cache (a tile past the map's end)
    + [(1, 1, 8, 20000, klen, 256, "bfloat16")
       for klen in (1, 64, 65, 4097, 20000)]
    + [(8, 1, 8, 4200, klen, 256, "bfloat16") for klen in (64, 65, 4097)]
    + [(128, 1, 8, 1100, 1090, 256, "bfloat16"),
       (100, 1, 8, 4200, 4097, 256, "bfloat16"),
       (132, 1, 8, 2200, 2177, 256, "bfloat16"),
       (66, 2, 16, 700, 640, 256, "bfloat16"),
       (133, 1, 8, 2200, 2177, 256, "bfloat16"),
       (133, 1, 1, 300, 1, 256, "bfloat16"),
       (3, 1, 1, 333, 333, 256, "bfloat16"),
       (2, 1, 8, 1, 1, 256, "bfloat16"),
       (3, 2, 16, 333, 270, 256, "bfloat16")])


def _decode_tol(want):
    """1e-4 in float32; in bf16 2e-2 or four bf16 steps of the largest
    |want| (2^(e - 7) in [2^e, 2^(e+1))), whichever is smaller: a long
    cache's outputs are far below 1, and 2e-2 would pass a kernel that
    ignored kv_len."""
    if want.dtype == torch.float32:
        return 1e-4
    m = float(want.float().abs().max())
    return min(2e-2, 4 * 2.0 ** (np.floor(np.log2(m)) - 7))


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_SWEEP, ids=str)
def test_decode_attention_kernel_matches_plain(cuda_device, case):
    B, KV, G, S, klen, hd, dt = case
    rng = np.random.default_rng(S + klen)
    dtype = getattr(torch, dt)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                               device=cuda_device).to(dtype)
               for shape in ((B, KV, G, hd), (B, KV, S, hd), (B, KV, S, hd)))
    length = torch.tensor([klen], dtype=torch.int32, device=cuda_device)
    before = build.LAUNCHES["decode_attention_bkgd"]
    out = DA.decode_attention_bkgd(q, k, v, length)
    want = DA.decode_attention_plain(q, k, v, klen)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_bkgd"] == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    atol = _decode_tol(want)
    err = float((out.float() - want.float()).abs().max())
    assert err <= atol, (err, atol)
    assert torch.equal(DA.decode_attention_bkgd(q, k, v, klen), out)
    # the JAX layout's wrapper reaches the same kernel
    got = ops.decode_attention(q.reshape(B, KV * G, hd), k.transpose(1, 2),
                               v.transpose(1, 2), length)
    assert torch.equal(got, out.reshape(B, KV * G, hd))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 2, 7, 4096, 3000, 64, "bfloat16"),
                                  (1, 2, 7, 20000, 4097, 64, "bfloat16"),
                                  (2, 2, 16, 8192, 8191, 128, "bfloat16"),
                                  (2, 2, 7, 1000, 999, 64, "float32"),
                                  (4, 1, 8, 4096, 3000, 256, "bfloat16"),
                                  (2, 1, 8, 1000, 777, 256, "float32")],
                         ids=str)
def test_decode_attention_reads_the_model_cache_in_place(cuda_device, case):
    """The model's (B, S, KV, hd) cache through ``ops.decode_attention``:
    the kernel reads it in place, bit-identical to the contiguous
    (B, KV, S, hd) call, and the call adds only its output and the split
    scratch to the peak memory."""
    B, KV, G, S, klen, hd, dt = case
    rng = np.random.default_rng(S + klen + G)
    dtype = getattr(torch, dt)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                               device=cuda_device).to(dtype)
               for shape in ((B, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    length = torch.tensor([klen], dtype=torch.int32, device=cuda_device)
    qg = q.reshape(B, KV, G, hd)
    dense = DA.decode_attention_bkgd(qg, k.transpose(1, 2).contiguous(),
                                     v.transpose(1, 2).contiguous(), length)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = ops.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    added = torch.cuda.max_memory_allocated() - base
    assert torch.equal(got, dense.reshape(B, KV * G, hd))
    assert torch.equal(ops.decode_attention(q, k, v, length), got)
    want = DA.decode_attention_plain(qg, k.transpose(1, 2),
                                     v.transpose(1, 2), klen)
    assert float((got.reshape(qg.shape).float() - want.float()).abs().max()
                 ) <= _decode_tol(want)
    nsplit = DA.split_count(B, KV, S, *DA._slots(
        got.device, hd, DA._DTYPE_CODES[dtype], G,
        build.library("decode_attention")))
    scratch = got.numel() * got.element_size() + 4 * DA.scratch_floats(
        B, KV, G, hd, nsplit)
    assert added <= scratch + 4096                    # no copy of k or v


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(2, 1, 8, 1000, 777, 256, "bfloat16"),
                                  (1, 1, 8, 20000, 4097, 256, "bfloat16"),
                                  (133, 1, 8, 700, 641, 256, "bfloat16"),
                                  (2, 1, 8, 1000, 1, 256, "bfloat16"),
                                  (2, 2, 7, 1000, 999, 64, "bfloat16"),
                                  (2, 2, 16, 1000, 777, 128, "bfloat16"),
                                  (2, 1, 8, 1000, 777, 256, "float32")],
                         ids=str)
def test_decode_attention_ignores_the_cache_past_kv_len(cuda_device, case):
    """NaN in every k and v row at kv_len or later changes nothing: the
    output is bit-identical to the same call with zeros there (a ragged
    tile's rows past kv_len are neither scored nor weighted into p v)."""
    B, KV, G, S, klen, hd, dt = case
    rng = np.random.default_rng(S + klen + hd)
    dtype = getattr(torch, dt)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                               device=cuda_device).to(dtype)
               for shape in ((B, KV, G, hd), (B, KV, S, hd), (B, KV, S, hd)))
    length = torch.tensor([klen], dtype=torch.int32, device=cuda_device)
    k[:, :, klen:] = 0
    v[:, :, klen:] = 0
    zeros = DA.decode_attention_bkgd(q, k, v, length)
    k[:, :, klen:] = float("nan")
    v[:, :, klen:] = float("nan")
    got = DA.decode_attention_bkgd(q, k, v, length)
    torch.cuda.synchronize()
    assert torch.equal(got, zeros)
    want = DA.decode_attention_plain(q, k[:, :, :klen], v[:, :, :klen], klen)
    assert float((got.float() - want.float()).abs().max()) <= _decode_tol(
        want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 96, 512])
def test_decode_attention_refuses_other_head_dims(cuda_device, hd):
    """Head dims 64, 128 and 256 launch; any other raises (no fallback)."""
    q = torch.zeros((1, 1, 4, hd), device=cuda_device, dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 64, hd), device=cuda_device, dtype=torch.bfloat16)
    before = build.LAUNCHES["decode_attention_bkgd"]
    with pytest.raises(ValueError, match="head_dim"):
        DA.decode_attention_bkgd(q, k, k, 10)
    assert build.LAUNCHES["decode_attention_bkgd"] == before
    assert DA.HEAD_DIMS == (64, 128, 256)


@pytest.mark.cuda
def test_cpu_tensors_never_launch_on_a_machine_with_a_card(cuda_device):
    before = dict(build.LAUNCHES)
    args = _scan_inputs((1, 2, 9, 16, 16, "float32"), "cpu")
    ops.rwkv6_scan(*args)
    ops.decode_attention(torch.zeros(1, 4, 64), torch.zeros(1, 8, 2, 64),
                         torch.zeros(1, 8, 2, 64), 3)
    assert build.LAUNCHES == before
    with pytest.raises(ValueError):
        RK.rwkv6_scan_bhtk(*(a.to(cuda_device) for a in args[:3]), *args[3:])


@pytest.mark.cuda
def test_rwkv_model_pallas_path_matches_plain_path(cuda_device):
    """The rwkv6-3b smoke model on the card: the kernel path (pallas)
    against the chunked plain path on the same weights, and the kernel
    launched once per layer per call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM
    from repro_torch.models import serve as TSV
    plain = get_smoke_config("rwkv6_3b")
    pallas = dataclasses.replace(plain, attn_impl="pallas")
    p = TM.init_params(torch.Generator(cuda_device).manual_seed(0), plain)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, plain.vocab_size, (2, 40)), device=cuda_device)
    before = build.LAUNCHES["rwkv6_scan_bhtk"]
    a = TSV.greedy_generate(p, plain, prompt, 5, 64)
    assert build.LAUNCHES["rwkv6_scan_bhtk"] == before
    b = TSV.greedy_generate(p, pallas, prompt, 5, 64)
    assert build.LAUNCHES["rwkv6_scan_bhtk"] == before + 5 * plain.n_layers
    assert torch.equal(a, b)
    la = TM.forward(p, plain, prompt).logits
    lb = TM.forward(p, pallas, prompt).logits
    torch.testing.assert_close(lb, la, rtol=0, atol=2e-2)


# ---------------------------------------------------------------------------
# the attention family of the model zoo on the card
# ---------------------------------------------------------------------------

def _zoo_smoke(name, **over):
    """A zoo smoke config at head dim 64 (a head dim both attention kernels
    take), ``attn_impl="pallas"``, float32."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(name), head_dim=64,
                               attn_impl="pallas", **over)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2_0p5b", "whisper_base",
                                  "granite_moe_3b_a800m"])
def test_zoo_serving_on_the_card_matches_the_cpu(cuda_device, name):
    """Prefill (260 tokens into a 264-row cache) and 4 decode steps on the
    card against the same port on the CPU (plain versions), at 1e-4 /
    1e-3; decode attention launches once per layer and step, the cache
    tensors never move; in whisper's prefill (300 frames) flash attention
    launches once per encoder layer and once per decoder layer's
    cross-attention.  Granite's MoE routes at its capacity factor 1.25
    (float32 router logits: no ties), so both devices drop the same
    assignments."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import model as TM
    from repro_torch.models import serve as TSV
    cfg = _zoo_smoke(name, enc_len=300)
    cpu = TM.init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    card = params_from_numpy(_to_numpy(cpu), cuda_device)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 264))
    frames = rng.normal(0, 1, (2, cfg.enc_len, cfg.d_model)).astype(
        np.float32) if cfg.enc_dec else None
    out = {}
    for dev, p in (("cpu", cpu), (cuda_device, card)):
        t = torch.as_tensor(toks, device=dev)
        fr = None if frames is None else torch.as_tensor(frames, device=dev)
        cache = TSV.init_cache(cfg, 2, 264, device=dev)
        ptrs = {k: a.data_ptr() for k, a in cache["layers"].items()}
        before = dict(build.LAUNCHES)
        logits, cache, _ = TSV.prefill(p, cfg, t[:, :260], cache=cache,
                                       frames=fr)
        flash = build.LAUNCHES["flash_attention_bhsd"] - \
            before.get("flash_attention_bhsd", 0)
        got = [logits]
        for i in range(260, 264):
            logits, cache = TSV.decode_step(p, cfg, t[:, i:i + 1],
                                            cache=cache)
            got.append(logits)
        assert {k: a.data_ptr() for k, a in cache["layers"].items()} == ptrs
        decode = build.LAUNCHES["decode_attention_bkgd"] - \
            before.get("decode_attention_bkgd", 0)
        out[str(dev)] = (torch.stack(got, 1).cpu(), flash, decode,
                         {k: a.cpu() for k, a in cache["layers"].items()})
    (want, f0, d0, c0), (have, f1, d1, c1) = out["cpu"], out["cuda"]
    assert (f0, d0) == (0, 0)
    # whisper: the encoder's 300^2 scores and the decoder's cross-attention
    # (260 x 300 > 256^2 scores, no cache) reach the flash dispatch
    assert f1 == (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)
    assert d1 == cfg.n_layers * 4
    torch.testing.assert_close(have, want, rtol=1e-4, atol=1e-3)
    for k in c0:
        torch.testing.assert_close(c1[k], c0[k], rtol=1e-4, atol=1e-3)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.cuda
def test_zoo_cacheless_forward_on_the_card_launches_flash(cuda_device):
    """qwen2's smoke model at hd 64: the cache-less forward over 300 tokens
    launches flash attention once per layer and agrees with the CPU."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models import model as TM
    cfg = _zoo_smoke("qwen2_0p5b")
    cpu = TM.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    card = params_from_numpy(_to_numpy(cpu), cuda_device)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 300))
    want = TM.forward(cpu, cfg, torch.as_tensor(toks)).logits
    before = build.LAUNCHES["flash_attention_bhsd"]
    got = TM.forward(card, cfg, torch.as_tensor(toks, device=cuda_device))
    assert build.LAUNCHES["flash_attention_bhsd"] == before + cfg.n_layers
    torch.testing.assert_close(got.logits.cpu(), want, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the aggregate half on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,d,splits", [(4096, 2, 8), (10 ** 6, 3, 100)])
def test_float64_accumulator_on_the_card_matches_numpy(cuda_device, n, d,
                                                       splits):
    from repro_torch.core import aggregates as AGG
    rng = np.random.default_rng(n)
    y = rng.normal(1000.0, 2.0, n)
    Z = y[:, None] * rng.uniform(0.5, 1.5, d) + rng.normal(0, 1.0, (n, d))
    parts = [AGG.CVAccumulator.init(d, device=cuda_device).update(
        torch.as_tensor(y[i], device=cuda_device),
        torch.as_tensor(Z[i], dtype=torch.float32, device=cuda_device))
        for i in np.array_split(np.arange(n), splits)]
    merged = parts[0]
    for a in parts[1:]:
        merged = merged.merge(a)
    reduced = AGG.distributed_reduce(parts)
    want = AGG.mcv_estimate(y, Z.astype(np.float32).astype(np.float64))
    for acc in (merged, reduced):
        assert acc.M2.is_cuda and acc.M2.dtype == torch.float64
        got = acc.estimate()
        assert got.n == n
        np.testing.assert_allclose([got.mean, got.var, got.naive_var],
                                   [want.mean, want.var, want.naive_var],
                                   rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_calibrate_on_the_card_times_with_cuda_events(cuda_device,
                                                      tmp_path,
                                                      monkeypatch):
    from repro_torch.core import costmodel as CM
    events = []
    real = torch.cuda.Event

    def spy(*a, **k):
        events.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", spy)
    p = str(tmp_path / "torch-cuda.json")
    ops.reset_launch_counts()
    m = CM.calibrate(batch=32, grid=16, classes=3, repeat=2, path=p,
                     device=cuda_device)
    counts = ops.launch_counts()
    assert events, "calibrate timed nothing with CUDA events"
    assert counts["spatial_stats_bgc"] > 0
    assert counts["spatial_stats_rows_bgc"] > 0
    assert m.backend == "torch-cuda" == CM.backend_key(cuda_device)
    assert m.fingerprint == CM.fingerprint_backend(cuda_device)
    assert m.fingerprint["capability"].count(".") == 1
    for c in m.coeffs.values():
        assert np.isfinite(c.per_row) and c.per_row > 0
        assert np.isfinite(c.overhead) and c.overhead >= 0
    assert CM.load_calibration(p, device=cuda_device).coeffs == m.coeffs
    assert CM.load_calibration(p, device="cpu") is None


@pytest.mark.cuda
def test_census_contract_through_session_on_the_card(cuda_device):
    from repro_torch.core.contracts import AggregateQuery
    from repro_torch.core.streaming import (AggregateStreamSession,
                                            QueryRegistry)
    n, C, g = 300, 3, 8
    rng = np.random.default_rng(3)
    objs = [[(int(rng.integers(0, C)), int(rng.integers(0, g)),
              int(rng.integers(0, g))) for _ in range(int(rng.poisson(2)))]
            for _ in range(n)]
    counts = np.zeros((n, C), np.float32)
    grid = np.zeros((n, g, g, C), np.float32)
    for f, ob in enumerate(objs):
        for c, r, col in ob:
            counts[f, c] += 1
            grid[f, r, col, c] = 1.0
    counts_d = torch.as_tensor(counts, device=cuda_device)
    grid_d = torch.as_tensor(grid, device=cuda_device)
    pred = Q.And((Q.ClassCount(0, Q.Op.GE, 1), Q.Spatial(0, Q.Rel.LEFT, 1)))
    truth = sum(Q.eval_objects(pred, o, C, g) for o in objs)
    # cv="off": exact verdicts would let the CV interval collapse before
    # every frame is oracled, and this is the census
    q = AggregateQuery(pred=pred, agg="count", eps=1e-9)
    reg = QueryRegistry()

    def filter_fn(idx):
        i = torch.as_tensor(idx, device=cuda_device)
        return FilterOutputs(counts=counts_d[i], grid=grid_d[i])

    with AggregateStreamSession(
            reg, q, filter_fn=filter_fn,
            oracle_fn=lambda idx: [objs[int(i)] for i in idx],
            n_frames=n, n_classes=C, grid=g, n_chunks=4, max_oracle=n,
            cv="off", device=cuda_device) as sess:
        res = sess.run()
        # the verdict tap: the plan's mask column on the card (the stats
        # kernel) and the count head's column, both float64 on the host
        ops.reset_launch_counts()
        tap = sess.executor.verdict_fn(np.arange(64))
        assert ops.launch_counts()["spatial_stats_bgc"] == 1
    assert tap.dtype == np.float64 and tap.shape == (64, 1)
    want = QueryPlan([pred]).evaluate(FilterOutputs(
        counts=torch.as_tensor(counts[:64]), grid=torch.as_tensor(grid[:64])))
    np.testing.assert_array_equal(tap[:, 0], want[:, 0].numpy())
    assert res.terminated in ("contract", "census") and res.satisfied
    assert res.estimate == pytest.approx(truth, rel=1e-12)
    assert res.half_width == 0.0
    assert res.oracle_calls == n == reg.budget_ledger.oracle_calls
    acc = sess.executor.pooled_accumulator()
    assert acc.M2.is_cuda and acc.M2.dtype == torch.float64


# ---------------------------------------------------------------------------
# fleet serving: the group plan and the temporal step on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("body", ["rows", "full", "auto"])
def test_group_plan_on_card_per_stream_identical(cuda_device, body):
    """``evaluate_group`` over S stacked streams on the card: the
    full-batch stats kernel runs once per stage over the flat S·B
    frames, and the compacted spatial stage hands the row kernel the
    flat ids ``s·B + r`` in one int64 tensor on the card, read in place;
    every stream's slice equals ``evaluate`` on that stream alone."""
    S, B = 4, 32
    rng = np.random.default_rng(9)
    counts = rng.normal(1, 1.5, (S, B, 3)).astype(np.float32)
    for s in range(S):                # rare class 2, rarer on early streams
        counts[s, rng.random(B) < 0.9 - 0.15 * s, 2] = 0.0
    grid = np.stack([_grid(20 + s, B=B, g=16) for s in range(S)])
    out = FilterOutputs(counts=torch.as_tensor(counts, device=cuda_device),
                        grid=torch.as_tensor(grid, device=cuda_device))
    queries = [Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                      Q.Spatial(2, Q.Rel.LEFT, 0))),
               Q.Count(Q.Op.GE, 3)]
    seen = []
    inner = SP.spatial_stats_rows_bgc

    def spy(grid_logits, rows, **kw):
        seen.append((grid_logits.data_ptr(), rows.dtype, rows.device.type,
                     tuple(rows.shape)))
        return inner(grid_logits, rows, **kw)

    ops.reset_launch_counts()
    ops.spatial_stats_rows_bgc = spy
    try:
        staged = QueryPlan(queries).build_staged(None, min_bucket=1,
                                                 spatial_body=body)
        got = staged.evaluate_group(out)
    finally:
        ops.spatial_stats_rows_bgc = inner
    launches = ops.launch_counts()
    rep = staged.last_report
    assert rep.ran == ["counts", "spatial"]
    if rep.bodies[1] == "rows":
        assert launches["spatial_stats_rows_bgc"] == 1
        assert seen == [(out.grid.data_ptr(), torch.int64, "cuda",
                         (rep.rows_evaluated[1],))]
    else:
        assert launches["spatial_stats_bgc"] == 1
    for s in range(S):
        want = QueryPlan(queries).evaluate(FilterOutputs(
            counts=out.counts[s].cpu(), grid=out.grid[s].cpu()))
        assert torch.equal(got[s].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 16])
def test_temporal_step_on_card_equals_numpy(cuda_device, S):
    """The batched automaton step on the card against the numpy loop:
    outputs and decidedness after every batch, bit for bit."""
    from repro_torch.core.temporal import TemporalProgram, advance_group
    c0, c1 = Q.ClassCount(0, Q.Op.GE, 1), Q.ClassCount(1, Q.Op.GE, 1)
    queries = (Q.Duration(c0, 4), Q.Duration(Q.ClassCount(2, Q.Op.GE, 6), 60),
               Q.SlidingCount(Q.Count(Q.Op.GE, 1), 8, Q.Op.GE, 1),
               Q.Sequence(c0, c1, 6),
               Q.And((c0, Q.SlidingCount(c1, 5, Q.Op.EQ, 2))))
    progs = [TemporalProgram(queries, device=cuda_device) for _ in range(S)]
    refs = [TemporalProgram(queries, backend="numpy") for _ in range(S)]
    rng = np.random.default_rng(S)
    M = progs[0].n_signals
    for p in progs + refs:
        p.start_window(64)
    for b0 in range(0, 64, 16):
        sig = rng.random((S, 16, M)) < 0.3 + 0.1 * (b0 // 16)
        got = advance_group(progs, torch.as_tensor(sig, device=cuda_device))
        for s in range(S):
            np.testing.assert_array_equal(got[s], refs[s].advance(sig[s]))
            np.testing.assert_array_equal(progs[s].query_decided,
                                          refs[s].query_decided)
            np.testing.assert_array_equal(progs[s].suppressed_signals(),
                                          refs[s].suppressed_signals())


@pytest.mark.cuda
def test_group_engine_copies_host_outputs_on_a_side_stream(cuda_device):
    """A fetch that returns host tensors: the engine copies the stacked
    chunk to the card on its side stream (the prefetched chunk too) and
    the answers equal each stream's plan on the host."""
    from repro_torch.distributed.multistream import (ShardedPlanGroupEngine,
                                                     route_streams)
    ctxs = route_streams([f"cam{i}" for i in range(4)], 1)
    rng = np.random.default_rng(3)
    data = {c.stream_id: (rng.poisson(1.0, (64, 3)).astype(np.float32),
                          _grid(40 + c.position, B=64, g=16))
            for c in ctxs}
    queries = [Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                      Q.Spatial(0, Q.Rel.LEFT, 1))),
               Q.Count(Q.Op.GE, 3)]

    def fetch(ctx, idx):
        c, g = data[ctx.stream_id]
        return FilterOutputs(counts=torch.as_tensor(c[idx]),
                             grid=torch.as_tensor(g[idx]))

    eng = ShardedPlanGroupEngine(queries, ctxs, fetch, device=cuda_device)
    first = eng.run_chunk(np.arange(0, 32), np.arange(32, 64))
    assert eng._next is not None and eng._next[2] is not None
    assert eng._next[1].counts.is_cuda
    second = eng.run_chunk(np.arange(32, 64))
    for ans, lo in ((first, 0), (second, 32)):
        for c in ctxs:
            want = QueryPlan(queries).evaluate(fetch(c, np.arange(lo,
                                                                  lo + 32)))
            np.testing.assert_array_equal(ans[c.position], want.numpy())


# ---------------------------------------------------------------------------
# the zoo's training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2_0p5b", "hymba_1p5b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, name):
    """Two AdamW steps of a smoke config (float32, hymba's under its
    published remat="selective") on the card against the port on the CPU
    from the same state and batch: loss, gradient norm and parameters at
    1e-4 / 1e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import state_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import step as TS
    cfg = get_smoke_config(name)
    opt = adamw(1e-3, eps=1e-4)
    cpu = TS.init_state(torch.Generator().manual_seed(7), cfg, opt,
                        device="cpu")
    card = state_from_numpy(_to_numpy(cpu), cuda_device)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 33))
    step_fn = TS.build_train_step(cfg, opt)
    out = {}
    for dev, st in (("cpu", cpu), ("cuda", card)):
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        ms = []
        for _ in range(2):
            st, m = step_fn(st, batch)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        assert st["params"]["embed"].device.type == dev
        out[dev] = (ms, [t.cpu() for t in tree_leaves(st["params"])])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_loader_copies_from_pinned_memory_in_order(cuda_device):
    """DeviceLoader on the card: batches arrive in order, equal to the
    host arrays, on the card; a step that reads each batch at once (on
    the current stream) sees the whole copy."""
    from repro_torch.data.pipeline import DeviceLoader, TokenStream
    stream = TokenStream(50000, 8, 4096, seed=3)
    want = [b for _, b in zip(range(6), iter(stream))]
    with DeviceLoader(iter(stream), device=cuda_device, prefetch=3) as ld:
        for w, b in zip(want, ld):
            assert b["tokens"].device.type == "cuda"
            assert b["tokens"].dtype == torch.int32
            s = (b["tokens"].long() * 3 + b["labels"].long()).sum()
            assert int(s) == int((w["tokens"].astype(np.int64) * 3
                                  + w["labels"]).sum())
            np.testing.assert_array_equal(b["labels"].cpu().numpy(),
                                          w["labels"])


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(cuda_device, tmp_path):
    """A state saved from the CPU (bf16 and float32 leaves) restores onto
    the card bit for bit; a card state saved asynchronously restores as
    it was when ``save_async`` was called."""
    from repro_torch.checkpoint import manager as CKPT
    g = torch.Generator().manual_seed(9)
    st = {"w": torch.randn((64, 32), generator=g).to(torch.bfloat16),
          "m": torch.randn((64, 32), generator=g),
          "step": torch.tensor(5, dtype=torch.int32)}
    tmpl = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in st.items()}
    CKPT.save(str(tmp_path / "a"), st, step=5)
    got, step = CKPT.restore(str(tmp_path / "a"), tmpl)     # default: card
    assert step == 5
    for k in st:
        assert got[k].device.type == "cuda" and got[k].dtype == st[k].dtype
        assert torch.equal(got[k].cpu(), st[k])
    # the async snapshot is taken at the call: a later in-place write on
    # the stream does not reach the file
    want = {k: v.clone() for k, v in got.items()}
    t = CKPT.save_async(str(tmp_path / "b"), got, step=6)
    got["m"].mul_(2.0)
    t.join(timeout=60)
    assert not t.is_alive()
    again, _ = CKPT.restore(str(tmp_path / "b"), tmpl, device=cuda_device)
    for k in st:
        assert torch.equal(again[k], want[k])


# ---------------------------------------------------------------------------
# the launch analyses and gradient compression on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,kind,attn", [
    ("qwen2_0p5b", "train", "xla_flash"), ("qwen2_0p5b", "decode", "pallas"),
    ("hymba_1p5b", "prefill", "xla_flash")])
def test_analysed_peak_matches_the_card(cuda_device, name, kind, attn):
    """``dryrun.analyse`` on meta against the same step on the card (the
    published widths at 2 layers, 2 x 256 tokens or a 256-row cache): the
    peak within 10% of ``max_memory_allocated`` above what was allocated
    before the step's arguments (cuBLAS's workspace made beforehand), the
    plain-version calls equal to the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    cfg = get_config(name, n_layers=2, attn_impl=attn)
    cell = ShapeCell("x", 256, 2, kind)
    pred = D.analyse(cfg, cell)
    for dt in (torch.bfloat16, torch.float32):      # cuBLAS workspaces
        x = torch.ones((64, 64), device=cuda_device, dtype=dt)
        (x @ x).sum().item()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(cuda_device).manual_seed(0)
    opt = adamw(1e-4) if kind == "train" else None
    first = (TS.init_state(gen, cfg, opt, device=cuda_device)
             if kind == "train" else M.init_params(gen, cfg,
                                                   device=cuda_device))
    S = 1 if kind == "decode" else 256
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    batch = {"tokens": toks}
    if kind == "train":
        batch["labels"] = toks
    else:
        batch["cache"] = SV.init_cache(cfg, 2, 256, device=cuda_device)
        if kind == "decode":
            batch["cache"]["len"].fill_(255)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    TS.step_for_cell(cfg, cell, opt)(first, batch)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    assert abs(pred["peak_bytes"] / measured - 1) <= 0.10, \
        (pred["peak_bytes"], measured)
    assert pred["kernel_calls"] == {k: n for k, n in
                                    ops.launch_counts().items() if n}


@pytest.mark.cuda
def test_compression_over_a_one_rank_nccl_group(cuda_device, tmp_path):
    """``allreduce_compressed`` over NCCL: the mean within scale / 2 of
    each leaf (a strided one included), two all-reduces a leaf counted by
    ``op_cost``, the new error g - decompress bit for bit."""
    import os
    import torch.distributed as dist
    from repro_torch.distributed import compression as C
    from repro_torch.launch import op_cost as OC
    g = torch.Generator(cuda_device).manual_seed(1)
    grads = {"a": torch.randn((300, 70), generator=g, device=cuda_device,
                              dtype=torch.bfloat16),
             "b": {"c": torch.randn((40, 9), generator=g,
                                    device=cuda_device).t()}}
    err = C.init_error_state(grads)
    q, s, new = C.compress(grads, err)
    deq = C.decompress(q, s)
    for k in (("a",), ("b", "c")):
        gk, dk, ek, sk = (t[k[0]] if len(k) == 1 else t[k[0]][k[1]]
                          for t in (grads, deq, new, s))
        assert torch.equal(ek, gk.float() - dk)
        assert float((dk - gk.float()).abs().max()) <= float(sk) * (
            0.5 + 127 * 2.0 ** -23)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with OC.OpCost() as cost:
            mean, _ = C.allreduce_compressed(grads, err)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert OC.summarize(cost.collectives)["all-reduce"]["count"] == 4
    for k, sk in (("a", s["a"]), ("c", s["b"]["c"])):
        m = mean[k] if k == "a" else mean["b"]["c"]
        gk = grads[k] if k == "a" else grads["b"]["c"]
        assert float((m - gk.float()).abs().max()) <= float(sk) * (
            0.5 + 127 * 2.0 ** -23)


@pytest.fixture
def nccl_world1(cuda_device, tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    LM.init_distributed(init_file=str(tmp_path / "store"), rank=0,
                        world_size=1)
    try:
        yield LM.make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["xla_flash", "pallas"])
def test_sharded_decode_equals_the_plain_decode(nccl_world1, attn):
    """At world 1 over NCCL: prefill and three decode steps of qwen2-0.5b's
    smoke config (at head dim 64, which the decode kernel takes) under
    ``ctx.decode_shard`` on the plan's DTensor cache equal the plain
    decode (``pallas``: the decode kernel) at 1e-4, the cache rows at
    1e-5, and the cache is written in place."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import ctx
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import step as TS
    dev = torch.device("cuda")
    mesh = nccl_world1
    cfg = dataclasses.replace(get_smoke_config("qwen2_0p5b"), head_dim=64,
                              attn_impl=attn)
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 20), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    cache = SV.init_cache(cfg, 4, 64, device=dev)
    _, cache, _ = SV.prefill(params, cfg, toks[:, :16], cache=cache)
    want = []
    for i in range(3):
        lg, cache = SV.decode_step(params, cfg, toks[:, 16 + i:17 + i],
                                   cache=cache)
        want.append(lg)
    _, plan = TS.jit_step_for_cell(cfg, ShapeCell("d", 64, 4, "decode"),
                                   mesh)
    dp = plan.place(params, plan.param_shardings)
    dcache = plan.place_inputs({"cache": SV.init_cache(cfg, 4, 64,
                                                       device=dev)})["cache"]
    ptr = dcache["layers"]["k"].to_local().data_ptr()
    ops.reset_launch_counts()
    with plan.sharder(), ctx.decode_shard(mesh):
        _, dcache, _ = SV.prefill(dp, cfg, plan.place(toks[:, :16],
                                                      ("data",)),
                                  cache=dcache)
        for i in range(3):
            lg, dcache = SV.decode_step(dp, cfg, plan.place(
                toks[:, 16 + i:17 + i], ("data",)), cache=dcache)
            assert float((lg.full_tensor() - want[i]).abs().max()) <= 1e-4
    assert ops.launch_counts()["decode_attention_bkgd"] == 0
    assert dcache["layers"]["k"].to_local().data_ptr() == ptr
    assert float((dcache["layers"]["k"].full_tensor()
                  - cache["layers"]["k"]).abs().max()) <= 1e-5
    assert int(dcache["len"].full_tensor()) == 19


@pytest.mark.cuda
def test_planned_train_step_equals_the_plain_step(nccl_world1):
    """At world 1 over NCCL: two of ``jit_step_for_cell``'s AdamW steps
    (weight decay 0.1) of qwen2-0.5b's smoke config against
    ``step_for_cell``'s from the same state: the losses at 1e-4, both
    moments within 1e-4 of each leaf's largest, and the parameters
    within 1e-3 of the rate where each step's gradient is at least 1e-2
    of its leaf's largest (elsewhere a gradient near AdamW's eps makes
    the step's size a rounding), which the steps moved by more than
    1e-2 of the rate."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import step as TS
    dev = torch.device("cuda")
    cfg = get_smoke_config("qwen2_0p5b")
    lr = 1e-3
    opt = adamw(lr, weight_decay=0.1)
    cell = ShapeCell("t", 32, 4, "train")
    state = TS.init_state(torch.Generator(dev).manual_seed(0), cfg, opt,
                          device=dev)
    plain = TS.step_for_cell(cfg, cell, opt)
    step, plan = TS.jit_step_for_cell(cfg, cell, nccl_world1, opt)
    want = got = state
    for i in range(2):
        g = torch.Generator(dev).manual_seed(1 + i)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                                  generator=g, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        want, wm = plain(want, batch)
        got, gm = step(got, batch)
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= 1e-4
        if i == 0:
            m_first = tree_leaves(want["opt"]["m"])
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(got["opt"][k]),
                        tree_leaves(want["opt"][k])):
            assert float((a.full_tensor() - b).abs().max()) <= \
                1e-4 * float(b.abs().max())
    for a, b, p0, m1, m2 in zip(
            tree_leaves(got["params"]), tree_leaves(want["params"]),
            tree_leaves(state["params"]), m_first,
            tree_leaves(want["opt"]["m"])):
        g1, g2 = m1.abs(), (m2 - 0.9 * m1).abs()
        keep = (g1 >= 1e-2 * g1.max()) & (g2 >= 1e-2 * g2.max())
        assert float((b - p0).abs()[keep].min()) > 1e-2 * lr
        assert float((a.full_tensor() - b).abs()[keep].max()) <= 1e-3 * lr

@pytest.mark.cuda
@pytest.mark.parametrize("arch,kernels", [
    ("rwkv6_3b", ("rwkv6_scan_bhtk",)),
    ("granite_moe_3b_a800m", ("decode_attention_bkgd",)),
    ("whisper_base", ("flash_attention_bhsd", "decode_attention_bkgd"))])
def test_family_kernels_launch_through_the_plan(nccl_world1, arch, kernels):
    """At world 1 over NCCL, under ``pallas``: a prefill and two decode
    steps of a family's smoke config (head dims the kernels take; a
    300-frame whisper encoder, which reaches flash attention) through
    ``jit_step_for_cell`` launch the family's kernels on the rank's chunk
    (``layers.local_call``) and equal the unsharded calls at 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import step as TS
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=64,
                              rwkv_head_dim=64, enc_len=300,
                              attn_impl="pallas")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    g = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 18), device=dev, generator=g,
                         dtype=torch.int32)
    frames = torch.randn((4, cfg.enc_len, cfg.d_model), device=dev,
                         generator=g) if cfg.enc_dec else None
    steps = [TS.jit_step_for_cell(cfg, ShapeCell(k, 32, 4, k),
                                  nccl_world1)[0]
             for k in ("prefill", "decode")]

    def serve(planned):
        cache = SV.init_cache(cfg, 4, 32, device=dev)
        batch = {"tokens": toks[:, :16], "cache": cache}
        if frames is not None:
            batch["frames"] = frames
        if planned:
            lg, cache = steps[0](params, batch)
        else:
            lg, cache, _ = SV.prefill(params, cfg, toks[:, :16], cache=cache,
                                      frames=frames)
        out = [lg]
        for i in range(2):
            t = toks[:, 16 + i:17 + i]
            lg, cache = (steps[1](params, {"tokens": t, "cache": cache})
                         if planned else
                         SV.decode_step(params, cfg, t, cache=cache))
            out.append(lg)
        return [x.full_tensor() if hasattr(x, "full_tensor") else x
                for x in out]

    want = serve(False)
    ops.reset_launch_counts()
    got = serve(True)
    launched = ops.launch_counts()
    for name in kernels:
        assert launched[name] > 0, launched
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4
