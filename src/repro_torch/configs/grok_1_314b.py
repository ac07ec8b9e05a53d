"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, attn softcap 30.
Full attention -> long_500k SKIPPED.  The flagship expensive oracle for
the paper's cascade (every frame through Grok vs filter-gated).
"""
from repro_torch.models.config import Activation, BlockKind, BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe", block=BlockKind.MOE,
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab_size=131072,
        n_experts=8, experts_per_token=2, capacity_factor=1.25,
        activation=Activation.GELU, logits_softcap=30.0,
        rope_theta=10000.0, max_seq_len=32768, remat="full",
        branch=BranchSpec(layer=12, grid=56, n_classes=8, kind="od",
                          head_dim=256),
    )
