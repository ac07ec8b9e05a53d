"""The port's launch analyses against the JAX package's, on the CPU.

- ``launch.specs.input_specs`` against the reference's (shape-only,
  through ``jax.eval_shape``), leaf by leaf in key path, shape and
  dtype, for all 10 archs x 4 shape cells.
- ``launch.op_cost`` against the reference's jaxpr (``jax.make_jaxpr``
  of the reference's unsharded ``build_*_step``; its sharded
  ``jit_step_for_cell`` fails, ROADMAP Queue 3) at the
  ``reduce_for_smoke`` configs of qwen2, granite-moe, hymba, rwkv6,
  whisper and paligemma, for the train step at remat none, full and
  selective, prefill and decode (2 x 32 tokens; and qwen2 and paligemma
  at 2 x 300 with 128-key chunks, which reaches the chunked attention):
  - dot FLOPs equal at rtol 1e-9, summed here with the reference's own
    ``_dot_flops`` over the jaxpr (scan bodies times their length).
    RWKV-6's WKV scan differs by terms pinned to their analytic size
    (``rwkv_dot_gap``);
  - ``argument_bytes`` equal to the bytes of the reference's leaves;
  - total FLOPs within 10% and bytes / heavy bytes at 0.5-1.25 x the
    reference's (measured at these configs: FLOPs 0.987-1.098, bytes
    0.61-1.02, heavy bytes 0.56-1.15; views cost nothing in the port,
    reshapes and broadcasts are equations in the jaxpr, and the port's
    in-place cache writes count the rows they write).
- The counts on ``meta`` equal the counts of the same step on real CPU
  tensors, peak included; the storage tracker on a hand-checked case.
- The collective summary of ``allreduce_compressed`` on a one-rank gloo
  group, and the wire model against ``hlo_analysis.Collective``.
- ``dryrun.run_cell``'s record layout beside the reference's, the
  per-kernel plain-call counts, and ``dryrun.main --out``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as RC
from repro.launch import hlo_analysis as RHLO
from repro.launch import jaxpr_cost as RJC
from repro.launch import specs as RSPECS
from repro.models import model as RM
from repro.models.config import SHAPE_CELLS as R_CELLS
from repro.models.config import ShapeCell as RCell
from repro.optim import adamw as r_adamw
from repro.train import step as RTS
from repro_torch import configs as TC
from repro_torch.distributed import compression as TCOMP
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_cost as OC
from repro_torch.launch import specs as TSPECS
from repro_torch.models.config import ShapeCell as TCell
from repro_torch.models.config import shape_cell

FAMILIES = ["qwen2_0p5b", "granite_moe_3b_a800m", "hymba_1p5b", "rwkv6_3b",
            "whisper_base", "paligemma_3b"]
FLOPS_RTOL = 0.10
BYTES_RATIO = (0.5, 1.25)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("cell", [c.name for c in R_CELLS])
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_input_specs_match_reference(arch, cell):
    ref = RSPECS.input_specs(RC.get_config(arch),
                             next(c for c in R_CELLS if c.name == cell))
    got = TSPECS.input_specs(TC.get_config(arch), shape_cell(cell))
    assert all(t.device.type == "meta" for t in _leaves(got))
    assert _flat(got) == _flat(ref)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# --------------------------------------------------------------------------
# op_cost against the reference's jaxpr
# --------------------------------------------------------------------------

def ref_dot_flops(jaxpr, mult=1.0, acc=None):
    """Dot FLOPs by lhs dtype, with the reference's ``_dot_flops``, scan
    bodies times their length (``analyze_jaxpr``'s walk)."""
    acc = {} if acc is None else acc
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "scan":
            ref_dot_flops(eqn.params["jaxpr"].jaxpr,
                          mult * eqn.params["length"], acc)
            continue
        assert name not in ("while", "cond"), name
        p = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
        if p is not None:
            ref_dot_flops(p.jaxpr if hasattr(p, "jaxpr") else p, mult, acc)
            continue
        if name == "dot_general":
            dt = str(eqn.invars[0].aval.dtype)
            acc[dt] = acc.get(dt, 0.0) + mult * RJC._dot_flops(eqn)
    return acc


def rwkv_dot_gap(cfg, B, T, kind, remat):
    """Reference dot FLOPs minus the port's for RWKV-6 (one chunk of T):
    - the bonus term's u-scaling, ``einsum("bhck,hk,bhck->bhc")``'s
      first pairwise product, is a dot_general with nothing contracted
      in JAX (2 FLOPs per (B, H, T, K) element) and an elementwise mul
      in the port: once per forward (and recompute);
    - at T = 1 (decode) ``torch.einsum`` also multiplies elementwise the
      two products whose contraction is the chunk of one: k^T v (B, H,
      K, V) and A v (B, H, 1, V);
    - training adds the u-scaling's two cotangents (du contracts b and
      c; the other is elementwise in JAX too, a dot_general), and three
      products JAX's scan transpose runs on the carry that the port's
      autograd skips (the final state is not in the loss): d(k) and
      d(v) of the state update and d(S0) of r S, 2 B H T K V each."""
    H, K = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    scale = 2 * B * H * T * K
    if kind != "train":
        per = scale
        if T == 1:
            per += 2 * B * H * K * K + 2 * B * H * K
        return cfg.n_layers * per
    fwd = 1 if remat == "none" else 2
    return cfg.n_layers * (scale * (fwd + 2) + 3 * 2 * B * H * T * K * K)


def _ref_step(rcfg, kind, B, S):
    specs = RSPECS.input_specs(rcfg, RCell("x", S, B, kind))
    if kind == "train":
        opt = r_adamw(1e-4, weight_decay=0.1)
        first = jax.eval_shape(
            lambda: RTS.init_state(jax.random.PRNGKey(0), rcfg, opt))
        fn = RTS.build_train_step(rcfg, opt)
    else:
        first = jax.eval_shape(
            lambda: RM.init_params(jax.random.PRNGKey(0), rcfg))
        fn = (RTS.build_prefill_step if kind == "prefill"
              else RTS.build_decode_step)(rcfg)
    jaxpr = jax.make_jaxpr(fn)(first, specs).jaxpr
    arg_bytes = sum(float(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                    for x in jax.tree.leaves((first, specs)))
    return jaxpr, arg_bytes


CASES = ([(a, k, "none", 32, 512) for a in FAMILIES
          for k in ("train", "prefill", "decode")]
         + [(a, "train", "full", 32, 512) for a in FAMILIES]
         + [(a, "train", "selective", 32, 512)
            for a in ("qwen2_0p5b", "hymba_1p5b", "rwkv6_3b")]
         + [("qwen2_0p5b", "train", "none", 300, 128),
            ("paligemma_3b", "prefill", "none", 300, 128)])


@pytest.mark.parametrize("arch,kind,remat,S,chunk", CASES)
def test_op_cost_matches_reference_jaxpr(arch, kind, remat, S, chunk):
    B = 2
    rcfg = dataclasses.replace(RC.get_smoke_config(arch), remat=remat,
                               attn_chunk=chunk)
    tcfg = dataclasses.replace(TC.get_smoke_config(arch), remat=remat,
                               attn_chunk=chunk)
    jaxpr, arg_bytes = _ref_step(rcfg, kind, B, S)
    ref = RJC.analyze_jaxpr(jaxpr)
    ref_dots = ref_dot_flops(jaxpr)
    got = D.analyse(tcfg, TCell("x", S, B, kind))
    assert set(got["dot_flops"]) == set(ref_dots) == {"float32"}
    gap = (rwkv_dot_gap(tcfg, B, 1 if kind == "decode" else S, kind, remat)
           if arch == "rwkv6_3b" else 0)
    np.testing.assert_allclose(got["dot_flops"]["float32"] + gap,
                               ref_dots["float32"], rtol=1e-9)
    assert got["argument_bytes"] == arg_bytes
    np.testing.assert_allclose(got["flops"], ref["flops"], rtol=FLOPS_RTOL)
    for k in ("bytes", "bytes_heavy"):
        assert BYTES_RATIO[0] <= got[k] / ref[k] <= BYTES_RATIO[1], \
            (k, got[k] / ref[k])
    assert got["peak_bytes"] >= got["argument_bytes"]
    assert got["kernel_calls"] == {}          # xla_flash: no kernel


def test_meta_counts_equal_real_cpu_counts():
    """The same train step on meta and on real CPU tensors: the same ops,
    FLOPs, bytes and peak of live storage bytes."""
    cfg = TC.get_smoke_config("qwen2_0p5b")
    cell = TCell("x", 16, 2, "train")
    meta = D.analyse(cfg, cell)
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    opt = adamw(1e-4, weight_decay=0.1)
    state = TS.init_state(torch.Generator().manual_seed(0), cfg, opt,
                          device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32))
             for k in ("tokens", "labels")}
    _, real = OC.count(TS.step_for_cell(cfg, cell, opt), state, batch)
    real = real.summary()
    for k in ("dot_flops", "bytes_heavy", "argument_bytes", "peak_bytes"):
        assert real[k] == meta[k], k
    # one host scalar of the clipping moves to the step's device: a copy
    # on meta (and on the card), none on the CPU
    assert meta["ops"] == {**real["ops"],
                           "_to_copy": real["ops"]["_to_copy"] + 1}
    assert (meta["flops"] - real["flops"], meta["bytes"] - real["bytes"]) \
        == (1, 8)


def test_peak_tracks_storage_lifetimes():
    x = torch.empty(1000, device="meta")           # 4000 bytes

    def f(x):
        a = x * 2                                  # +4000
        b = a.reshape(10, 100)                     # a view: +0
        c = torch.zeros(500, dtype=torch.float64, device="meta")  # +4000
        del a, c
        return b.sum(0)                            # +400, peak 12000 before
    out, cost = OC.count(f, x)
    assert cost.argument_bytes == 4000
    assert cost.peak_bytes == 12000
    assert cost.live_bytes == 4000 + 400           # x and out: b went with f
    assert cost.ops["mul"] == 1 and cost.ops["view"] == 1
    assert cost.bytes == 4000 * 2 + 4000 + 4000 + 400


def test_conv_flops_match_reference_formula():
    """A convolution's FLOPs as ``jaxpr_cost._conv_flops`` counts the
    forward; its backward (stride 1, same padding, one group) is two
    convolutions of the same size."""
    x = torch.empty((2, 8, 9, 9), device="meta", requires_grad=True)
    w = torch.empty((16, 8, 3, 3), device="meta", requires_grad=True)
    with OC.OpCost() as cost:
        torch.nn.functional.conv2d(x, w, padding=1).sum().backward()
    rx = jax.ShapeDtypeStruct((2, 9, 9, 8), np.float32)
    rw = jax.ShapeDtypeStruct((3, 3, 8, 16), np.float32)
    eqn = jax.make_jaxpr(lambda a, b: jax.lax.conv_general_dilated(
        a, b, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    )(rx, rw).jaxpr.eqns[0]
    fwd = RJC._conv_flops(eqn)
    assert cost.ops["convolution"] == cost.ops["convolution_backward"] == 1
    # less the sum (its input's elements; its backward is a view)
    assert cost.flops - 2 * 16 * 9 * 9 == 3 * fwd


def test_collective_summary_of_allreduce_compressed(tmp_path):
    g = {"a": torch.randn(30, 7), "b": {"c": torch.randn(5)}}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with OC.OpCost(g) as cost:
            TCOMP.allreduce_compressed(g, TCOMP.init_error_state(g))
    finally:
        dist.destroy_process_group()
    s = OC.summarize(cost.collectives)
    assert set(s) == {"all-reduce", "total"}
    # two per leaf: the int32 payload and the float32 scale
    assert s["all-reduce"]["count"] == 4
    assert s["all-reduce"]["operand_bytes"] == 4 * (30 * 7 + 5) + 4 * 2
    assert s["total"]["wire_bytes"] == 0.0          # a group of one
    assert {c.group_size for c in cost.collectives} == {1}
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for n in (1, 2, 4, 8):
            assert OC.Collective(op, 1e6, n).wire_bytes == \
                RHLO.Collective(op, 1e6, n).wire_bytes


def test_kernel_calls_counted_under_pallas():
    """On meta the plain versions stand in for the kernels and are
    counted: decode attention once per layer of a pallas decode step."""
    cfg = dataclasses.replace(TC.get_smoke_config("qwen2_0p5b"),
                              attn_impl="pallas")
    got = D.analyse(cfg, TCell("x", 32, 2, "decode"))
    assert got["kernel_calls"] == {"decode_attention_bkgd": cfg.n_layers}
    assert ops.launch_counts()["decode_attention_bkgd"] == 0


def test_run_cell_record_and_main(tmp_path, capsys):
    rec = D.run_cell("qwen2_0p5b", "decode_32k")
    assert rec["status"] == "ok" and rec["mesh"] == "one-card"
    # the reference's layout, less XLA's own numbers and timings
    assert set(rec) >= {"arch", "shape", "mesh", "chips", "params",
                        "active_params", "status", "analyse_s", "memory",
                        "cost", "collectives", "roofline"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes", "fits_hbm"}
    assert set(rec["cost"]) == {"flops_global", "dot_flops",
                                "bytes_heavy_global",
                                "bytes_unfused_ceiling_global"}
    assert set(rec["roofline"]) == {
        "compute_s", "memory_s", "memory_s_unfused_ceiling", "collective_s",
        "model_flops", "useful_flops_frac", "tokens", "bottleneck"}
    r = rec["roofline"]
    assert r["tokens"] == 128 and r["collective_s"] == 0.0
    assert rec["collectives"] == {} and rec["kernel_calls"] == {}
    cfg = TC.get_config("qwen2_0p5b")
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["argument_bytes"] >= cache
    assert rec["memory"]["fits_hbm"]
    assert r["model_flops"] == 2 * cfg.active_param_count() * 128
    assert np.isclose(r["memory_s"], rec["cost"]["bytes_heavy_global"]
                      / D.H100["hbm_bw"])
    skip = D.run_cell("qwen2_0p5b", "long_500k")
    assert skip["status"].startswith("skip: long_500k")

    D.main(["--arch", "qwen2_0p5b", "--shape", "long_500k", "--out",
            str(tmp_path), "--tag", "t"])
    path = tmp_path / "qwen2_0p5b__long_500k__one-card__t.json"
    assert json.loads(path.read_text())["status"].startswith("skip")
    assert "[dryrun] qwen2_0p5b__long_500k__one-card__t: skip" in \
        capsys.readouterr().out


def test_main_records_a_failing_cell_and_goes_on(tmp_path, monkeypatch,
                                                  capsys):
    """A cell that raises is written as an ERROR record with its
    traceback, and the sweep goes on to the next cell."""
    real = D.run_cell

    def run_cell(arch, shape, remat=None):
        if shape == "decode_32k":
            raise RuntimeError("boom")
        return real(arch, shape, remat=remat)
    monkeypatch.setattr(D, "run_cell", run_cell)
    monkeypatch.setattr(D, "SHAPE_CELLS",
                        [shape_cell("decode_32k"), shape_cell("long_500k")])
    monkeypatch.setattr(D, "ARCHS", ["qwen2_0p5b"])
    D.main(["--all", "--out", str(tmp_path)])
    bad = json.loads((tmp_path / "qwen2_0p5b__decode_32k__one-card.json")
                     .read_text())
    assert bad["status"] == "ERROR: RuntimeError: boom"
    assert "RuntimeError: boom" in bad["traceback"]
    assert (tmp_path / "qwen2_0p5b__long_500k__one-card.json").exists()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and "ERROR: RuntimeError: boom" in out[0]
