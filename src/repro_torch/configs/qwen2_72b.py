"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Pure full attention -> long_500k is SKIPPED (documented in DESIGN.md).
Training this (~1 TB AdamW state) relies on the FSDP(data) x TP(model)
layout; remat=full bounds activation memory.
"""
from repro_torch.models.config import BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=29568, vocab_size=152064, qkv_bias=True,
        rope_theta=1e6, max_seq_len=32768, remat="full",
        branch=BranchSpec(layer=16, grid=56, n_classes=8, kind="od",
                          head_dim=256),
    )
