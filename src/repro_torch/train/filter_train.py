"""The paper's filter model: input projection + trunk prefix + branch head.

The filter = input projection (stub-frontend width -> d_model) + learned
positions + the first k trunk layers (``models.model.forward`` with
``tap_layer=k, stop_at_tap=True``) + an IC / OD / OD-COF branch head.
This module holds the serving half: building the model and running it.
Training (``train_filter``, the optimizers, the paper metrics) arrives
with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import filters as F
from repro_torch.device import DeviceLike, require_on, resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import BranchSpec, ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]


def default_trunk(d_model: int = 128, n_layers: int = 4,
                  grid: int = 8) -> ModelConfig:
    """Small bidirectional trunk for the filter (the 'VGG-prefix' analog)."""
    return ModelConfig(
        name="filter-trunk", n_layers=n_layers, d_model=d_model,
        n_heads=4, n_kv_heads=4, head_dim=d_model // 4, d_ff=4 * d_model,
        vocab_size=32, dtype="float32", use_rope=False,
        max_seq_len=grid * grid + 8, attn_impl="xla_naive")


def init_filter_model(gen: Union[torch.Generator, int],
                      trunk_cfg: ModelConfig, spec: BranchSpec, d_in: int,
                      device: DeviceLike = None) -> Params:
    """Random filter weights from an explicit generator (or an integer
    seed for a CPU generator), placed on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    pos = torch.randn((spec.grid * spec.grid + 8, trunk_cfg.d_model),
                      generator=gen, device=gen.device) * 0.02
    return {
        "proj": dense_init(gen, d_in, (d_in, trunk_cfg.d_model),
                           torch.float32, dev),
        "pos": pos.to(dev),
        "trunk": M.init_params(gen, trunk_cfg, dev),
        "branch": F.branch_init(gen, spec, trunk_cfg.d_model, dev),
    }


def filter_forward(p: Params, trunk_cfg: ModelConfig, spec: BranchSpec,
                   embeds, use_kernel: bool = False,
                   device: DeviceLike = None) -> F.FilterOutputs:
    """embeds: (B, P, d_in) stub-frontend patches -> FilterOutputs.

    ``embeds`` may be a numpy array or a tensor; it is placed on
    ``device`` (default CUDA), where the parameters must already be."""
    dev = resolve_device(device)
    require_on(p["proj"], dev, "filter parameters")
    x = torch.as_tensor(embeds, device=dev).float()
    x = torch.einsum("bpd,de->bpe", x, p["proj"])
    x = x + p["pos"][: x.shape[1]][None]
    out = M.forward(p["trunk"], trunk_cfg, embeds=x, tap_layer=spec.layer,
                    stop_at_tap=True, causal=False)
    if out.tap is None:
        raise ValueError(f"branch layer {spec.layer} is outside the "
                         f"{trunk_cfg.n_layers}-layer trunk")
    return F.branch_apply(p["branch"], out.tap, spec,
                          **({"use_kernel": use_kernel}
                             if spec.kind == "ic" else {}))


@dataclasses.dataclass
class TrainedFilter:
    params: Params
    trunk_cfg: ModelConfig
    spec: BranchSpec
    losses: list
    count_scale: Optional[np.ndarray] = None   # per-class target scale

    def _rescale(self, out: F.FilterOutputs) -> F.FilterOutputs:
        if self.count_scale is None:
            return out
        scale = torch.as_tensor(self.count_scale, dtype=torch.float32,
                                device=out.counts.device)
        return F.FilterOutputs(counts=out.counts * scale, grid=out.grid)

    def apply(self, embeds, use_kernel: bool = False,
              device: DeviceLike = None) -> F.FilterOutputs:
        return self._rescale(filter_forward(self.params, self.trunk_cfg,
                                            self.spec, embeds,
                                            use_kernel=use_kernel,
                                            device=device))
