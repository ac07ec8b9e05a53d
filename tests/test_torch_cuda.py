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
       (1, 77, 300, 4, 4, 128, False, None, "float32")])


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
FLASH_STRESS = [(hd, causal, kind) for hd in (32, 128)
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
    for hd in (16, 96):
        q2, k2, v2 = _qkv((1, 64, 64, 2, 2, hd, True, None, "float32"),
                          cuda_device)
        with pytest.raises(ValueError, match="head_dim"):
            FA.flash_attention_bhsd(q2, k2, v2)
    with pytest.raises(TypeError):
        FA.flash_attention_bhsd(q.half(), k.half(), v.half())
    off = torch.empty(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention_bhsd(off, k, v)
    assert build.LAUNCHES["flash_attention_bhsd"] == before + 1


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
    + [(1, 2, G, 8192, 8000, 128, "bfloat16") for G in (7, 16)])


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
                                  (2, 2, 7, 1000, 999, 64, "float32")],
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
    scratch = got.numel() * got.element_size() + (
        B * KV * nsplit * G * (hd + 2) * 4 if nsplit > 1 else 0)
    assert added <= scratch + 4096                    # no copy of k or v


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
