"""Model configuration system.

One ``ModelConfig`` describes every architecture in the assigned pool:
dense GQA transformers, MoE transformers, RWKV6, hybrid attention+SSM
(Hymba), encoder-decoder (Whisper) and prefix-VLM (PaliGemma).

Everything downstream (init, forward, sharding, serving caches, the
filter branches from the paper) is driven by this dataclass, so adding an
architecture is a config file in ``repro/configs/``.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class BlockKind(str, enum.Enum):
    """Kind of the (homogeneous) layer stack."""

    ATTN = "attn"              # attention + MLP (dense transformer)
    MOE = "moe"                # attention + mixture-of-experts MLP
    RWKV6 = "rwkv6"            # RWKV-6 "Finch" time-mix + channel-mix
    HYBRID = "hybrid"          # Hymba: parallel attention + Mamba heads, + MLP


class Activation(str, enum.Enum):
    SILU = "silu"
    GELU = "gelu"
    RELU = "relu"


@dataclasses.dataclass(frozen=True)
class BranchSpec:
    """Where/how the paper's filter branch attaches to a trunk.

    ``layer`` mirrors the paper's k (VGG19 k=5 for IC, Darknet-19 k=8 for
    OD): the branch consumes the activations after the first ``layer``
    trunk layers.  ``grid`` is the paper's g (56).  ``n_classes`` is the
    number of object classes the filter counts/localises.
    """

    layer: int = 5
    grid: int = 56
    n_classes: int = 8
    kind: str = "ic"           # "ic" (GAP+FC head) | "od" (3-conv head, Table I)
    head_dim: int = 256        # feature width fed to the CAM head
    max_count: int = 32        # counts are regressed; clip range for eval


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"                    # dense | moe | ssm | hybrid | audio | vlm

    # --- trunk geometry -------------------------------------------------
    block: BlockKind = BlockKind.ATTN
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None           # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    activation: Activation = Activation.SILU
    glu: bool = True                         # gated MLP (SwiGLU/GeGLU); False = plain 2-matmul MLP
    qkv_bias: bool = False                   # Qwen2-style
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    layernorm: bool = False                  # False = RMSNorm, True = LayerNorm (whisper/starcoder)
    rope_theta: float = 10000.0
    use_rope: bool = True
    learned_pos: bool = False                # whisper decoder absolute positions
    scale_embed: bool = False                # gemma-style sqrt(d_model) embed scale
    max_seq_len: int = 8192
    sliding_window: Optional[int] = None     # sliding-window attention (hymba long ctx)

    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "gather"                 # gather | alltoall (shard_map EP)

    # --- SSM (rwkv6 / hymba-mamba) ---------------------------------------
    ssm_state: int = 16                      # mamba N (hymba)
    ssm_expand: int = 2                      # mamba d_inner = expand * d_model
    ssm_conv: int = 4                        # mamba depthwise conv width
    rwkv_head_dim: int = 64                  # rwkv6 head size

    # --- encoder-decoder (whisper) ---------------------------------------
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_len: int = 1500                      # whisper: fixed 30 s -> 1500 frames

    # --- VLM prefix (paligemma) -------------------------------------------
    vlm_prefix: int = 0                      # number of image-patch positions (stub embeds)

    # --- paper technique: filter branch ------------------------------------
    branch: Optional[BranchSpec] = None

    # --- numerics / performance -------------------------------------------
    dtype: str = "bfloat16"                  # activation/param dtype for lowering
    remat: str = "none"                      # none | full | selective
    attn_impl: str = "xla_flash"             # xla_flash | xla_naive | pallas
    attn_chunk: int = 512                    # kv-block for xla_flash scan
    scan_layers: bool = True                 # lax.scan over stacked layer params
    logits_softcap: float = 0.0              # grok-style tanh soft-capping (0 = off)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0 or self.n_kv_heads == 0, (
            self.n_heads, self.n_kv_heads)

    # --- derived ----------------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk); used for 6ND."""
        d, f, h, kv, hd = (self.d_model, self.d_ff, self.n_heads,
                           self.n_kv_heads, self.head_dim)
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d     # q,k,v,o
        mlp = d * f * (3 if self.glu else 2)
        per_layer = 0
        if self.block in (BlockKind.ATTN, BlockKind.MOE, BlockKind.HYBRID):
            per_layer += attn
        if self.block == BlockKind.MOE:
            per_layer += self.n_experts * mlp + d * self.n_experts  # experts + router
        elif self.block in (BlockKind.ATTN, BlockKind.HYBRID):
            per_layer += mlp
        if self.block == BlockKind.HYBRID:
            di, n = self.d_inner, self.ssm_state
            per_layer += d * 2 * di + di * self.ssm_conv + di * 2 * n + di + di * d
        if self.block == BlockKind.RWKV6:
            per_layer += 5 * d * d + d * d          # time-mix r,k,v,w,g + out
            per_layer += 2 * d * f                  # channel-mix (rwkv ff)
        n_stacks = self.n_layers + (self.n_enc_layers if self.enc_dec else 0)
        if self.enc_dec:  # cross-attention in decoder
            per_layer_dec_extra = attn
            return emb + self.n_layers * (per_layer + per_layer_dec_extra) + \
                self.n_enc_layers * per_layer
        return emb + n_stacks * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.block != BlockKind.MOE or self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = d * f * (3 if self.glu else 2)
        dense = self.param_count() - self.n_layers * self.n_experts * mlp
        return dense + self.n_layers * self.experts_per_token * mlp


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell: what to lower in the dry-run."""

    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


def supports_long_context(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic archs (SSM / hybrid)."""
    return cfg.block in (BlockKind.RWKV6, BlockKind.HYBRID)


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        n_enc_layers=2 if cfg.enc_dec else 0,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=8,
        rwkv_head_dim=16,
        enc_len=32,
        vlm_prefix=16 if cfg.vlm_prefix else 0,
        max_seq_len=512,
        dtype="float32",
        branch=BranchSpec(layer=1, grid=8, n_classes=4, head_dim=32,
                          kind=cfg.branch.kind) if cfg.branch else None,
    )
