"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one (decided at run
time, in the ``cuda_device`` fixture).  They import neither jax nor the
JAX package, so on a machine without JAX they run without the suite's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Spatial stats are held bit for bit; the CAM head at 1e-4 (the same fp32
products summed in another order), with TF32 off for matmuls and cuDNN.
Flash attention is held at max abs err 1e-4 in float32 and 2e-2 in
bfloat16 (one bf16 rounding of outputs of magnitude ~1), as
tests/test_kernels.py holds the Pallas kernel.
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
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
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
