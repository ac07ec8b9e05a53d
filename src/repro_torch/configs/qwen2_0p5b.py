"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense GQA, QKV bias, tied embeddings.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
Full attention -> long_500k SKIPPED.  Small enough to double as the
*filter trunk* in the paper-technique examples (the cheap branch backbone
gating a large oracle, e.g. qwen2-72b).
"""
from repro_torch.models.config import BranchSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
        rope_theta=1e6, max_seq_len=32768, remat="none",
        branch=BranchSpec(layer=5, grid=56, n_classes=8, kind="ic",
                          head_dim=256),
    )
