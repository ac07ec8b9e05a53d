"""Input specifications for every (architecture x shape cell).

The JAX package's ``launch/specs.py`` on one card: its
``ShapeDtypeStruct`` stand-ins become tensors on the ``meta`` device,
which carry a shape and a dtype and allocate nothing, and the port's
steps run on them as they are (``launch/dryrun.py``).  Modality
frontends are stubs, as in the reference: audio and vision inputs arrive
as precomputed frame / patch embeddings at d_model width.

``input_shardings`` maps these inputs onto a device mesh: the cache by
``serve.cache_axes``, every other input split on its batch.  It returns
specs (``distributed/sharding.py``), which ``ShardPlan.place`` turns
into DTensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import serve as SV
from repro_torch.models.config import ModelConfig, ShapeCell

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_inputs(cfg: ModelConfig, cell: ShapeCell,
                 with_labels: bool) -> Dict[str, Any]:
    """Token / embedding inputs of one step (train or prefill)."""
    B, S = cell.global_batch, cell.seq_len
    dt = L.dtype_of(cfg)
    out: Dict[str, Any] = {}
    s_text = S
    if cfg.vlm_prefix:
        p = min(cfg.vlm_prefix, S // 2)
        s_text = S - p
        out["embeds"] = _spec((B, p, cfg.d_model), dt)
    if cfg.enc_dec:
        out["frames"] = _spec((B, cfg.enc_len, cfg.d_model), dt)
    out["tokens"] = _spec((B, s_text), torch.int32)
    if with_labels:
        out["labels"] = _spec((B, s_text), torch.int32)
    return out


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Meta-device inputs of the cell's step function.

    train:   {tokens, labels[, embeds][, frames]}
    prefill: {tokens[, embeds][, frames], cache}   (empty cache, len 0)
    decode:  {tokens (B, 1), cache}                (a seq_len-row cache)
    """
    if cell.kind == "train":
        return batch_inputs(cfg, cell, with_labels=True)
    cache = SV.init_cache(cfg, cell.global_batch, cell.seq_len, device=META)
    if cell.kind == "prefill":
        b = batch_inputs(cfg, cell, with_labels=False)
        b["cache"] = cache
        return b
    return {"tokens": _spec((cell.global_batch, 1), torch.int32),
            "cache": cache}


def input_shardings(cfg: ModelConfig, cell: ShapeCell, mesh,
                    rules=None) -> Dict[str, Any]:
    """Specs matching the ``input_specs`` structure."""
    rules = rules or SH.DEFAULT_RULES
    specs = input_specs(cfg, cell)
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = SH.tree_specs(SV.cache_axes(cfg), v, mesh, rules)
        else:
            out[k] = SH.spec_for(("batch",) + (None,) * (v.dim() - 1),
                                 v.shape, mesh, rules)
    return out
